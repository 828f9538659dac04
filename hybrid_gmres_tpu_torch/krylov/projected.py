"""Masked projected solves on the padded Hessenberg (PyTorch port).

Twin of ``hybrid_gmres_tpu/krylov/projected.py``.  The solves keep the
static padded ``(maxit+1, maxit)`` shape: columns with index >= kdim are
zeroed and an identity is injected on the inactive diagonal, so the padded
system is nonsingular and its solution is zero beyond kdim — slot for slot
the same numbers as the JAX package.

Both solves use the ``_ex`` LAPACK/cuSOLVER entry points, which report
failure in a device tensor instead of checking it on the host: the plain
``torch.linalg.cholesky``/``solve`` would add one host sync per iteration.
"""

from __future__ import annotations

import torch


def _inactive_diag(maxit: int, kdim, dtype, device):
    """Diagonal mask that is 1.0 on rows/cols with index >= kdim, else 0."""
    idx = torch.arange(maxit, device=device)
    return (idx >= kdim).to(dtype)


def _mask_columns(H, kdim):
    col = torch.arange(H.shape[1], device=H.device)
    return torch.where(col[None, :] < kdim, H, torch.zeros((), dtype=H.dtype,
                                                           device=H.device))


def projected_ls_solve(H, t, kdim):
    """LS solution of ``min || t - H y ||`` over the first ``kdim`` columns
    (Householder QR of the padded matrix; MATLAB backslash on the k-step
    system).  Returns padded ``y`` of length maxit, zero beyond kdim."""
    maxit = H.shape[1]
    dtype, device = H.dtype, H.device
    H = _mask_columns(H, kdim)
    Qr, R = torch.linalg.qr(H, mode="reduced")
    g = Qr.T @ t
    active = torch.arange(maxit, device=device) < kdim
    zero = torch.zeros((), dtype=dtype, device=device)
    g = torch.where(active, g, zero)
    Rm = R + torch.diag(_inactive_diag(maxit, kdim, dtype, device))
    y, _ = torch.linalg.solve_ex(Rm, g)
    return torch.where(active, y, zero)


def projected_tikhonov_solve(H, t, lam, kdim):
    """Tikhonov-projected solve ``(H'H + lam I) y = H' t`` on the active
    block (the reference's shifted normal equations), by Cholesky."""
    maxit = H.shape[1]
    dtype, device = H.dtype, H.device
    H = _mask_columns(H, kdim)
    G = H.T @ H
    lam = torch.as_tensor(lam, dtype=dtype, device=device)
    G = G + lam * torch.eye(maxit, dtype=dtype, device=device) + torch.diag(
        _inactive_diag(maxit, kdim, dtype, device))
    rhs = H.T @ t
    L, _ = torch.linalg.cholesky_ex(G)
    y = torch.cholesky_solve(rhs[:, None], L).squeeze(1)
    idx = torch.arange(maxit, device=device)
    return torch.where(idx < kdim, y, torch.zeros((), dtype=dtype,
                                                  device=device))
