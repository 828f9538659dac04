"""GCV objective on the projected problem (PyTorch port).

Twin of the first part of ``hybrid_gmres_tpu/reg/gcv.py``: the GCV value
from a padded Hessenberg factorization, and its lambda-independent factors
for a cheap sweep over a lambda grid.  ``gcv_curve``, ``gcv_surface``, the
bounded Brent minimizer and ``gcv_lambda`` are not ported yet (ROADMAP
queue 1, item 8).

GCV objective (``gcv_function.m:35-54``):
    GCV(lam) = || t_k - Hbar y(lam) ||^2 / (N - sum_i s_i^2/(s_i^2+lam))^2
with ``y(lam)`` the Tikhonov-projected solution, ``s_i`` the singular values
of the *square* block ``H_k`` and ``N`` the full problem dimension (m for
'ab', n for 'ba').  NaN/Inf and tiny denominators map to 1e20.

Where the JAX package maps these functions over a batch or a lambda grid
with ``vmap``, the batch is written out here: ``H`` and ``t`` may carry
leading batch dimensions, ``kdim`` and ``lam`` broadcast against them.
"""

from __future__ import annotations

import torch

from hybrid_gmres_tpu_torch.krylov.projected import (
    mask_columns,
    projected_tikhonov_solve,
)
from hybrid_gmres_tpu_torch.utils.device import scalar_tensor


def _finish(residual_norm_sq, trace_val, trace_dim, weight):
    dtype = residual_norm_sq.dtype
    denominator = (trace_dim - weight * trace_val) ** 2
    gcv = residual_norm_sq / denominator
    bad = torch.isnan(gcv) | torch.isinf(gcv) | \
        (denominator < torch.finfo(dtype).eps)
    return torch.where(bad, torch.full((), 1e20, dtype=dtype,
                                       device=gcv.device), gcv)


def gcv_from_H(H, t, lam, trace_dim, kdim, weight=1.0, R=None, rhs=None):
    """GCV value from a padded Hessenberg factorization.

    ``H``: (..., kmax+1, kmax) padded (columns >= kdim zero); ``t``:
    (..., kmax+1) padded ``beta e1``; ``trace_dim``: the N in the
    denominator.  ``lam`` may be a scalar or a tensor of the batch's shape.

    ``weight``: the weighted-GCV parameter omega, denominator
    ``(N - omega * trace)^2``; 1.0 is plain GCV.  ``R``/``rhs`` (optional):
    evaluate the numerator in the ORIGINAL data space as
    ``||rhs - R y(lam)||^2`` with ``R`` the (m, kmax) image of the solution
    basis (BA: ``A Q_k``); see the JAX package's docstring for why.
    """
    kmax = H.shape[-1]
    dtype, device = H.dtype, H.device
    lam = scalar_tensor(lam, dtype, device)
    H = mask_columns(H, kdim)
    y = projected_tikhonov_solve(H, t, lam, kdim)
    if R is None:
        resid = t - (H @ y[..., None])[..., 0]
    else:
        resid = rhs - (R @ y[..., None])[..., 0]
    residual_norm_sq = torch.sum(resid * resid, dim=-1)
    # Singular values of the square block H_k: the padded square part's
    # inactive rows/cols are zero -> extra zero singular values, which add
    # 0/(0+lam) = 0 to the trace term (svd(H(1:k,1:k)), gcv_function.m:42).
    s = torch.linalg.svdvals(H[..., :kmax, :kmax])
    trace_val = torch.sum(s**2 / (s**2 + lam[..., None]), dim=-1)
    return _finish(residual_norm_sq, trace_val, trace_dim, weight)


def gcv_factors(H, t, kdim):
    """The lambda-INDEPENDENT factors of the GCV objective: one economy SVD
    of the padded ``Hbar`` (solve/numerator) plus the singular values of the
    square block ``H_k`` (trace).  With ``y(lam) = V diag(s/(s^2+lam)) U^T
    t`` and ``||t - Hbar y||^2 = sum_i (lam/(s_i^2+lam))^2 (u_i^T t)^2 +
    ||t_perp||^2`` each lambda then costs O(k).  Returns ``(sb, g,
    t_perp_sq, s_tr)`` with the batch dimensions of ``H`` leading."""
    kmax = H.shape[-1]
    H = mask_columns(H, kdim)
    Ub, sb, _ = torch.linalg.svd(H, full_matrices=False)
    g = (Ub.mT @ t[..., None])[..., 0]                # (..., kmax)
    t_perp_sq = torch.clamp(torch.sum(t * t, dim=-1) -
                            torch.sum(g * g, dim=-1), min=0)
    s_tr = torch.linalg.svdvals(H[..., :kmax, :kmax])
    return sb, g, t_perp_sq, s_tr


def gcv_from_factors(factors, lam, trace_dim, weight=1.0):
    """GCV(lam) from :func:`gcv_factors`, O(k) per value.  ``lam``: a scalar
    or a tensor whose shape broadcasts against the factors' batch shape; for
    a whole grid at once give the factors a trailing batch dimension of 1
    (``f.unsqueeze(...)``) and ``lam`` the grid."""
    sb, g, t_perp_sq, s_tr = factors
    lam = scalar_tensor(lam, g.dtype, g.device)[..., None]
    shrink = lam / (sb**2 + lam)
    residual_norm_sq = torch.sum(shrink**2 * g * g, dim=-1) + t_perp_sq
    trace_val = torch.sum(s_tr**2 / (s_tr**2 + lam), dim=-1)
    return _finish(residual_norm_sq, trace_val, trace_dim, weight)


def gcv_grid_lambda(H, t, kdim, grid, trace_dim):
    """The grid value minimizing GCV for each problem of the batch: two SVDs
    per problem, then every grid point at O(k).  ``grid``: (G,) tensor.
    Returns a tensor of the batch's shape."""
    sb, g, t_perp_sq, s_tr = gcv_factors(H, t, kdim)
    vals = gcv_from_factors(
        (sb[..., None, :], g[..., None, :], t_perp_sq[..., None],
         s_tr[..., None, :]), grid, trace_dim)           # (..., G)
    return grid[torch.argmin(vals, dim=-1)]
