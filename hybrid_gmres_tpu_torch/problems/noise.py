"""Seeded noise injection and back-projector perturbation (PyTorch port).

Twin of ``hybrid_gmres_tpu/problems/noise.py``: the same numpy generators
from the same seeds, so both packages draw the same numbers.  Relative noise
``b + level * ||b|| * e/||e||`` and operator mismatch ``B = A^T + c E``.
A torch tensor comes back as tensors on its device, a numpy array as numpy
arrays, in the input's dtype.
"""

from __future__ import annotations

import numpy as np
import torch


def _like(arr, ref):
    if isinstance(ref, torch.Tensor):
        return torch.as_tensor(arr, device=ref.device).to(ref.dtype)
    return arr.astype(ref.dtype)


def _host64(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def add_noise(b, level: float, seed: int = 0):
    """Return ``(b_noise, e)`` with ``||e|| = level * ||b||``."""
    rng = np.random.default_rng(seed)
    b_np = _host64(b)
    e = rng.standard_normal(b_np.shape)
    e = e / np.linalg.norm(e) * level * np.linalg.norm(b_np)
    return _like(b_np + e, b), _like(e, b)


def perturb_backprojector(A, scale: float, seed: int = 0,
                          normalize: bool = False):
    """Return ``(B, E)`` with ``B = A^T + scale * E`` and Gaussian ``E``.

    With ``normalize=True`` the perturbation is scaled so
    ``||scale * E||_F = scale``; otherwise raw ``scale * randn``.
    """
    rng = np.random.default_rng(seed)
    A_np = _host64(A)
    E = rng.standard_normal(A_np.T.shape)
    if normalize:
        E = E / np.linalg.norm(E, "fro")
    E = scale * E
    return _like(A_np.T + E, A), _like(E, A)
