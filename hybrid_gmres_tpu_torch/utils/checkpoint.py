"""Solve fingerprints (PyTorch port of ``utils/checkpoint.py``).

Only :func:`resume_fingerprint` is ported, so that ``GMRESResult.fp`` holds
the same (3,) encoding as the JAX package.  Save, load and resume are not
ported yet (ROADMAP queue 1, item 7).
"""

from __future__ import annotations

import torch


def resume_fingerprint(x0, lam, tag: str = "", device=None):
    """Compact (3,) float32 fingerprint of a solve's ``(x0, lam, tag)``.

    Entry 0 is a fixed-weight cosine checksum of ``x0`` (0 when None),
    entry 1 encodes ``lam`` exactly (scalar value; None -> -1, "gcv" -> -2,
    "gcv-final" -> -3; a per-RHS vector -> a fixed-weight checksum), entry 2
    encodes ``tag``.  Built on ``device`` (default: ``x0``'s, else CPU).
    """
    if device is None:
        device = x0.device if isinstance(x0, torch.Tensor) else "cpu"
    f32 = dict(dtype=torch.float32, device=device)
    codes = {"gcv": -2.0, "gcv-final": -3.0}
    if isinstance(lam, str):
        lam_val = torch.tensor(codes.get(lam, -9.0), **f32)
    elif lam is None:
        lam_val = torch.tensor(-1.0, **f32)
    else:
        lam_arr = torch.as_tensor(lam, **f32).reshape(-1)
        if lam_arr.shape[0] == 1:
            lam_val = lam_arr[0]
        else:
            wl = torch.cos(torch.arange(lam_arr.shape[0], **f32) * 1.234) + 0.5
            lam_val = torch.dot(lam_arr, wl)
    tag_val = torch.tensor(float(sum((i + 1) * ord(c)
                                     for i, c in enumerate(tag))), **f32)
    if x0 is None:
        xs = torch.tensor(0.0, **f32)
    else:
        x = torch.as_tensor(x0).reshape(-1).to(**f32)
        w = torch.cos(torch.arange(x.shape[0], **f32) * 0.7368) + 0.5
        xs = torch.dot(x, w)
    return torch.stack([xs, lam_val, tag_val])
