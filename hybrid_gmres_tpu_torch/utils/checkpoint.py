"""Krylov-state checkpoint / resume (PyTorch port of ``utils/checkpoint.py``).

A solver result carries the full padded Krylov factorization, so it can be
saved and a solve *continued* from it with a larger iteration budget:
``resume(save(run(maxit=k)), maxit=K)`` equals ``run(maxit=K)``.  The
``.npz`` layout (keys, shapes, dtypes) is the JAX package's, so either
package loads the other's file, GMRES results and GKB (LSQR/LSMR) states
alike.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from hybrid_gmres_tpu_torch.utils.device import require_device

_FIELDS = ("x", "err_hist", "res_hist", "niters", "Q", "H", "beta")
_OPTIONAL = ("IMG", "S", "active", "fp")


def save_state(path: str, result) -> None:
    """Write a solver result (single-RHS or batched) as a compressed
    ``.npz``; the optional fields are written only when present."""
    d = {name: getattr(result, name).detach().cpu().numpy()
         for name in _FIELDS}
    d["niters"] = d["niters"].astype(np.int32)
    for name in _OPTIONAL:
        val = getattr(result, name, None)
        if val is not None:
            d[name] = val.detach().cpu().numpy()
    np.savez_compressed(path, **d)


def load_state(path: str, device="cuda"):
    """Load a saved solver state onto ``device`` (the card by default; it
    raises without one, pass ``"cpu"`` for the CPU path).

    Legacy checkpoints (saved before the ``active`` flag existed) resume
    through a heuristic, ``active = (niters == len(res_hist))``, which
    cannot tell a run that stopped exactly on its final budgeted iteration
    from one that ran out of budget.  A ``UserWarning`` is emitted for
    exactly that ambiguous case.
    """
    # the solvers import this module for the fingerprint
    from hybrid_gmres_tpu_torch.solvers.common import GMRESResult

    device = require_device(device)
    with np.load(path) as z:
        arrays = {name: z[name] for name in z.files}
    out = GMRESResult(**{
        name: torch.as_tensor(arrays[name], device=device)
        for name in _FIELDS + _OPTIONAL if name in arrays})
    out = out._replace(niters=out.niters.to(torch.int32))
    ni = arrays["niters"]
    if "active" not in arrays and ni.ndim == 0 and \
            int(ni) == len(arrays["res_hist"]):
        warnings.warn(
            "legacy checkpoint without an 'active' flag whose niters equals "
            "its budget: resume will assume the run was still ACTIVE, which "
            "is wrong if it stopped (tol/breakdown) exactly on its final "
            "iteration — re-save with the current version to disambiguate",
            UserWarning, stacklevel=2)
    return out


def resume_fingerprint(x0, lam, tag: str = "", device=None):
    """Compact (3,) float32 fingerprint of a solve's ``(x0, lam, tag)``.

    Entry 0 is a fixed-weight cosine checksum of ``x0`` (0 when None),
    entry 1 encodes ``lam`` exactly (scalar value; None -> -1, "gcv" -> -2,
    "gcv-final" -> -3; a per-RHS vector -> a fixed-weight checksum), entry 2
    encodes ``tag``.  Built on ``device`` (default: ``x0``'s, else CPU).

    The ``lam`` and ``tag`` slots are compared exactly, so they are HOST
    values: computed with numpy in float32, the vector checksum with the
    same weights in the same order whatever the device (a device dot product
    may sum in another order), then moved.  Only the ``x0`` checksum is a
    device sum; it is compared with a tolerance.  A ``lam`` tensor is read
    on the host here, once per solve.
    """
    if device is None:
        device = x0.device if isinstance(x0, torch.Tensor) else "cpu"
    f32 = dict(dtype=torch.float32, device=device)
    lam_val, _ = _lam_slot(lam)
    tag_val = np.float32(sum((i + 1) * ord(c) for i, c in enumerate(tag)))
    if x0 is None:
        xs = torch.tensor(0.0, **f32)
    else:
        x = torch.as_tensor(x0).reshape(-1).to(**f32)
        w = torch.cos(torch.arange(x.shape[0], **f32) * 0.7368) + 0.5
        xs = torch.dot(x, w)
    return torch.cat([xs.reshape(1), torch.tensor(
        [float(lam_val), float(tag_val)], **f32)])


def _lam_slot(lam):
    """(value, slack) of the fingerprint's ``lam`` slot, float32 on the host.

    A scalar, None or a mode string is encoded exactly (slack 0).  A per-RHS
    vector is a fixed-weight checksum, the JAX package's weights in index
    order; XLA and numpy round the cosines and order the sum differently, so
    a checksum made by the other package is held to the rounding bound of a
    float32 sum of these R terms, ``R eps sum|lam_i w_i|``."""
    codes = {"gcv": -2.0, "gcv-final": -3.0}
    if isinstance(lam, str):
        return np.float32(codes.get(lam, -9.0)), 0.0
    if lam is None:
        return np.float32(-1.0), 0.0
    if isinstance(lam, torch.Tensor):
        lam = lam.detach().cpu().numpy()
    lam_arr = np.asarray(lam, np.float32).reshape(-1)
    if lam_arr.shape[0] == 1:
        return lam_arr[0], 0.0
    wl = (np.cos(np.arange(lam_arr.shape[0], dtype=np.float32)
                 * np.float32(1.234)) + np.float32(0.5)).astype(np.float32)
    terms = lam_arr * wl
    slack = lam_arr.shape[0] * np.finfo(np.float32).eps * float(
        np.abs(terms).sum())
    return np.float32(terms.sum(dtype=np.float32)), slack


def check_fingerprint(resume_from, x0, lam, tag: str = "") -> None:
    """Verify a resume's ``(x0, lam)`` against the checkpointed fingerprint
    (reads both on the host).  No-op when the checkpoint predates
    fingerprints (``fp is None``)."""
    stored = getattr(resume_from, "fp", None)
    if stored is None:
        return
    s = stored.detach().cpu().numpy()
    e = resume_fingerprint(x0, lam, tag=tag, device="cpu").numpy()
    if s.size == 2:
        # legacy (2,) fingerprint (lam slot carried an additive tag
        # offset): untagged checkpoints check cleanly with tag slot 0;
        # tagged ones fail the exact lam compare below — conservative
        s = np.append(s, 0.0)
    # x0 slot is a lossy float checksum — tolerance; lam and tag slots are
    # exact encodings of the argument, so any difference means a genuinely
    # different solve (a per-RHS lam vector's checksum: see _lam_slot)
    x0_ok = np.allclose(s[0], e[0], rtol=1e-5, atol=1e-6, equal_nan=True)
    lam_ok = s[1] == e[1] or abs(float(s[1]) - float(e[1])) <= \
        _lam_slot(lam)[1]
    if not (x0_ok and lam_ok and s[2] == e[2]):
        raise ValueError(
            f"resume fingerprint mismatch: checkpoint was created with "
            f"(x0, lam, tag) fingerprint {s.tolist()}, resume passed "
            f"{e.tolist()} — resuming with a different x0/lam silently "
            "corrupts the continuation; pass the ORIGINAL x0/lam (to "
            "change them, start a fresh solve warm-started from .x)")


def check_resumable(resume_from) -> None:
    """Reject restarted aggregates: their ``niters`` counts ALL cycles but
    ``Q``/``H`` hold only the last cycle's factorization."""
    k0 = int(resume_from.niters)
    if k0 > resume_from.H.shape[1]:
        raise ValueError(
            f"resume_from.niters={k0} exceeds its checkpointed budget "
            f"{resume_from.H.shape[1]} — this is a restarted result, which "
            "holds only the last cycle's factorization and is not "
            "resumable; warm-start a new solve from its .x instead")


def pad_state(result, maxit: int):
    """Grow a single-RHS padded factorization to a larger iteration
    budget (histories padded with NaN, bases with zero columns)."""
    old = result.H.shape[1]
    if maxit < old:
        raise ValueError(f"cannot shrink state: maxit={maxit} < {old}")
    if maxit == old:
        return result
    extra = maxit - old
    pad = torch.nn.functional.pad

    def pad_cols(M):
        return None if M is None else pad(M, (0, extra))

    return result._replace(
        err_hist=pad(result.err_hist, (0, extra), value=float("nan")),
        res_hist=pad(result.res_hist, (0, extra), value=float("nan")),
        Q=pad_cols(result.Q), H=pad(result.H, (0, extra, 0, extra)),
        IMG=pad_cols(result.IMG), S=pad_cols(result.S))


def save_gkb_state(path: str, state) -> None:
    """Serialize a :class:`GKBState` (LSQR/LSMR resume checkpoint) in the
    JAX package's layout: the carry stored positionally as ``carry_{i}``
    with ``carry_len``, absent entries (the reorth bases when
    ``reorth=False``) skipped."""
    def host(t):
        return t.detach().cpu().numpy()

    d = {"res_hist": host(state.res_hist), "err_hist": host(state.err_hist),
         "carry_len": np.int64(len(state.carry))}
    if state.ar_hist is not None:
        d["ar_hist"] = host(state.ar_hist)
    if getattr(state, "fp", None) is not None:
        d["fp"] = host(state.fp)
    for i, c in enumerate(state.carry):
        if c is not None:
            d[f"carry_{i}"] = host(c)
    np.savez_compressed(path, **d)


def load_gkb_state(path: str, device="cuda"):
    """Load a GKB state written by either package onto ``device`` (the card
    by default; it raises without one, pass ``"cpu"``)."""
    from hybrid_gmres_tpu_torch.utils.convert import gkb_state_from_numpy

    with np.load(path) as z:
        arrays = {name: z[name] for name in z.files}
    n = int(arrays["carry_len"])
    return gkb_state_from_numpy(
        carry=tuple(arrays.get(f"carry_{i}") for i in range(n)),
        res_hist=arrays["res_hist"], err_hist=arrays["err_hist"],
        ar_hist=arrays.get("ar_hist"), fp=arrays.get("fp"),
        device=require_device(device))
