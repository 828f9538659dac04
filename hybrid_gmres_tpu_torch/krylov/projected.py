"""Masked projected solves on the padded Hessenberg (PyTorch port).

Twin of ``hybrid_gmres_tpu/krylov/projected.py``.  The solves keep the
static padded ``(maxit+1, maxit)`` shape: columns with index >= kdim are
zeroed and an identity is injected on the inactive diagonal, so the padded
system is nonsingular and its solution is zero beyond kdim — slot for slot
the same numbers as the JAX package.

Where the JAX package maps a solve over a batch with ``vmap``, the batch is
written out here: ``H`` may be ``(..., maxit+1, maxit)`` and ``t``
``(..., maxit+1)`` with any leading batch dimensions, ``kdim`` and ``lam``
may be Python scalars or tensors that broadcast against those dimensions,
and all the systems go down in one LAPACK/cuSOLVER call.

Both solves use the ``_ex`` entry points, which report failure in a device
tensor instead of checking it on the host: the plain
``torch.linalg.cholesky``/``solve`` would add one host sync per iteration.
"""

from __future__ import annotations

import torch

from hybrid_gmres_tpu_torch.utils.device import scalar_tensor


def _over(v, ndim: int):
    """A scalar or batch-shaped tensor, ready to broadcast against a batch
    of arrays with ``ndim`` trailing dimensions."""
    if isinstance(v, torch.Tensor):
        return v[(...,) + (None,) * ndim]
    return v


def _active(maxit: int, kdim, device):
    """Bool mask (..., maxit): True on slots with index < kdim."""
    return torch.arange(maxit, device=device) < _over(kdim, 1)


def mask_columns(H, kdim):
    """``H`` with the columns of index >= kdim zeroed."""
    return torch.where(_active(H.shape[-1], kdim, H.device)[..., None, :], H,
                       torch.zeros((), dtype=H.dtype, device=H.device))


def projected_ls_solve(H, t, kdim):
    """LS solution of ``min || t - H y ||`` over the first ``kdim`` columns
    (Householder QR of the padded matrix; MATLAB backslash on the k-step
    system).  Returns padded ``y`` (..., maxit), zero beyond kdim."""
    maxit = H.shape[-1]
    dtype, device = H.dtype, H.device
    H = mask_columns(H, kdim)
    Qr, R = torch.linalg.qr(H, mode="reduced")
    active = _active(maxit, kdim, device)
    zero = torch.zeros((), dtype=dtype, device=device)
    g = torch.where(active, (Qr.mT @ t[..., None])[..., 0], zero)
    Rm = R + torch.diag_embed((~active).to(dtype))
    y, _ = torch.linalg.solve_ex(Rm, g[..., None])
    return torch.where(active, y[..., 0], zero)


def projected_tikhonov_solve(H, t, lam, kdim):
    """Tikhonov-projected solve ``(H'H + lam I) y = H' t`` on the active
    block (the reference's shifted normal equations), by Cholesky.

    The Gram ``H'H`` squares the conditioning of ``H``: in float32, once
    the Krylov space has taken in the small singular values, a ``lam``
    below the Gram's rounding (``eps ||H||^2``) leaves it indefinite, the
    Cholesky meets a non-positive pivot and ``y`` turns NaN (AB-GMRES on
    CT at n=128 on the card, ``scripts_torch/ab_gram_check.py``).  So the
    Gram, the Cholesky and the solve run in float64 whatever the working
    dtype (a ``(maxit, maxit)`` system), and ``y`` is rounded back to
    ``H``'s dtype."""
    maxit = H.shape[-1]
    dtype, device = H.dtype, H.device
    work = torch.float64
    H = mask_columns(H, kdim).to(work)
    active = _active(maxit, kdim, device)
    lam = _over(scalar_tensor(lam, work, device), 2)
    G = H.mT @ H + lam * torch.eye(maxit, dtype=work, device=device) + \
        torch.diag_embed((~active).to(work))
    L, _ = torch.linalg.cholesky_ex(G)
    y = torch.cholesky_solve(H.mT @ t.to(work)[..., None], L)[..., 0]
    return torch.where(active, y.to(dtype),
                       torch.zeros((), dtype=dtype, device=device))


def projected_gram_tikhonov_solve(G_full, rhs_full, lam, kdim):
    """Solve ``(G + lam I) y = rhs`` restricted to the leading kdim block.

    ``G_full`` (..., maxit, maxit) must be zero outside its leading kdim x
    kdim block and ``rhs_full`` (..., maxit) zero beyond kdim; ``lam`` and
    ``kdim`` may be Python scalars or tensors.  Used by the hybrid-LSMR
    normal equations (``hybrid_lsmr_solver.m:41-44``) and the AB-RTP inner
    solve.  LU through ``solve_ex``: no host sync."""
    maxit = G_full.shape[-1]
    dtype, device = G_full.dtype, G_full.device
    active = _active(maxit, kdim, device)
    lam = _over(scalar_tensor(lam, dtype, device), 2)
    G = G_full + lam * torch.eye(maxit, dtype=dtype, device=device) + \
        torch.diag_embed((~active).to(dtype))
    y, _ = torch.linalg.solve_ex(G, rhs_full[..., None])
    return torch.where(active, y[..., 0],
                       torch.zeros((), dtype=dtype, device=device))
