"""GCV-based regularization-parameter selection on the projected problem
(PyTorch port).

Twin of ``hybrid_gmres_tpu/reg/gcv.py``: the GCV value from a padded
Hessenberg factorization, its lambda-independent factors for a cheap sweep
over a lambda grid, and the selectors built on one Arnoldi factorization:
``gcv_curve`` (a lambda grid at fixed k), ``gcv_surface`` (a (k, lambda)
grid) and ``gcv_lambda`` (a bounded Brent minimization on the host,
``fminbnd`` parity).  The reference re-runs the Arnoldi for every objective
evaluation (``gcv_function.m``); it is lambda-independent, so here it runs
once (the ``plot_gcv_surface.m:58-102`` pattern).

The selectors evaluate the objective in float64 on the factorization the
solve's dtype gave (``_float64``): the Arnoldi and its products run in
float32 on the card, but the objective can be flatter than float32
resolves.  On the CT scenario (n=64, 25% noise, 'ba', k=20, the
original-space numerator) it varies by 3e-7 over the lambda grid
1e-8..1e-1; evaluated in float32 (the CPU path, float32 operators) it is
off by 4e-5 and comes out constant, so its argmin lands at 1e-8 where
float64 puts it at 0.1, and the surface's per-k path moves the same way.
On the same float32 factorization a float64 evaluation gives float64's
choices, to a grid step.  The JAX package evaluates in the working dtype (the TPU has no
float64); on float64 inputs the two agree.

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

import math

import torch

from hybrid_gmres_tpu_torch.krylov.arnoldi import arnoldi
from hybrid_gmres_tpu_torch.krylov.projected import (
    mask_columns,
    projected_tikhonov_solve,
)
from hybrid_gmres_tpu_torch.ops.linear_operator import as_operator, as_vector
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


def _arnoldi_for(gcv_type, A, B, b, k_gcv, breakdown_tol=1e-12):
    """One Arnoldi factorization for GCV ('ab': M = A B on b; 'ba': M = B A
    on B b), with ``gcv_function.m:4-32``'s 1e-12 breakdown tolerance.
    Returns ``(H, t, trace_dim, nsteps, Q, A, b)``."""
    b = as_vector(b)
    A = as_operator(A, device=b.device)
    B = as_operator(B, device=b.device)
    if gcv_type == "ab":
        def mv(q):
            return A.matvec(B.matvec(q))
        r0 = b
        trace_dim = A.shape[0]
    elif gcv_type == "ba":
        def mv(q):
            return B.matvec(A.matvec(q))
        r0 = B.matvec(b)
        trace_dim = A.shape[1]
    else:
        raise ValueError("gcv_type must be 'ab' or 'ba'")
    Q, H, beta, nsteps = arnoldi(mv, r0, int(k_gcv),
                                 breakdown_tol=breakdown_tol)
    t = torch.zeros((int(k_gcv) + 1,), dtype=H.dtype, device=H.device)
    t[0] = beta
    return H, t, trace_dim, nsteps, Q, A, b


def _original_space_R(gcv_type, A, b, Q, H):
    """(R, rhs) for the original-space GCV numerator ``||b - R y||``.

    BA: the iterate is ``x = Q_k y``, so ``R = A Q_k``: one multi-RHS
    product (``A.matmat``) of the column-major basis' first ``kmax``
    columns.  AB: ``x = B Q_k y`` and ``A B Q_k = Q_{k+1} Hbar_k``, so
    ``R = Q Hbar`` costs no product (and equals the projected numerator)."""
    if gcv_type == "ab":
        return Q @ H, b
    return A.matmat(Q[:, :H.shape[1]]), b


def _maybe_original(residual_space, gcv_type, A, b, Q, H):
    if residual_space == "projected":
        return None, None
    if residual_space != "original":
        raise ValueError("residual_space must be 'projected' or 'original'")
    return _original_space_R(gcv_type, A, b, Q, H)


def _float64(*tensors):
    """The objective's inputs in float64 (None stays None)."""
    return tuple(None if a is None else a.to(torch.float64)
                 for a in tensors)


def gcv_curve(gcv_type, A, B, b, k_gcv, lam_grid, weight=1.0,
              residual_space="projected"):
    """GCV(lam) over a grid at fixed Krylov dimension ``k_gcv``: one
    factorization, then the whole grid in one batched evaluation.

    Like ``gcv_function.m:33`` the projected dimension stays ``k_gcv`` even
    if the Arnoldi broke down early (the trailing columns are zero).
    ``residual_space``: "projected" (reference parity) or "original" (the
    data-space numerator; see :func:`gcv_from_H`).  Float64 values (see
    the module's docstring)."""
    H, t, trace_dim, _, Q, A, b = _arnoldi_for(gcv_type, A, B, b, k_gcv)
    H, t, R, rhs = _float64(
        H, t, *_maybe_original(residual_space, gcv_type, A, b, Q, H))
    grid = torch.as_tensor(lam_grid, dtype=H.dtype, device=H.device)
    L = grid.shape[0]
    return gcv_from_H(H.expand(L, -1, -1), t.expand(L, -1), grid, trace_dim,
                      int(k_gcv), weight, R, rhs)


def gcv_surface(gcv_type, A, B, b, k_range, lam_grid):
    """GCV(k, lam) surface and the per-k argmin-lambda path.

    The ``plot_gcv_surface.m:58-102`` pattern: ONE Arnoldi to
    ``max(k_range)``, then every (k, lambda) pair on the projected system
    in one batched evaluation.  Returns ``(surface, path)``, surface of
    shape (len(lam_grid), len(k_range)), in float64 (see the module's
    docstring)."""
    kmax = int(max(k_range))
    H, t, trace_dim, _, _, _, _ = _arnoldi_for(gcv_type, A, B, b, kmax)
    H, t = _float64(H, t)
    grid = torch.as_tensor(lam_grid, dtype=H.dtype, device=H.device)
    ks = torch.as_tensor(list(k_range), dtype=torch.int32, device=H.device)
    K, L = ks.shape[0], grid.shape[0]
    Hk = mask_columns(H.expand(K, -1, -1), ks)      # the k-step systems
    surface = gcv_from_H(Hk[:, None].expand(K, L, -1, -1),
                         t.expand(K, L, -1), grid.expand(K, L), trace_dim,
                         ks[:, None]).T             # (L, K)
    return surface, grid[torch.argmin(surface, dim=0)]


def minimize_scalar_bounded(f, lo, hi, tol=1e-8, maxiter=200):
    """Golden-section + parabolic bounded scalar minimization (fminbnd
    parity), on the host: ``analyze_regularization.m:37-46`` (TolX=1e-8).
    ``f`` returns anything ``float()`` reads (one host read per
    evaluation).  Returns ``(x, f(x))``."""
    golden = 0.5 * (3.0 - math.sqrt(5.0))
    a, b = float(lo), float(hi)
    x = w = v = a + golden * (b - a)
    fx = fw = fv = float(f(x))
    d = e = 0.0
    for _ in range(int(maxiter)):
        m = 0.5 * (a + b)
        tol1 = tol * abs(x) + 1e-25
        tol2 = 2.0 * tol1
        if abs(x - m) <= tol2 - 0.5 * (b - a):
            break
        use_golden = True
        if abs(e) > tol1:
            # parabolic fit through (v, fv), (w, fw), (x, fx)
            r = (x - w) * (fx - fv)
            q = (x - v) * (fx - fw)
            p = (x - v) * q - (x - w) * r
            q = 2.0 * (q - r)
            if q > 0.0:
                p = -p
            q = abs(q)
            etemp = e
            e = d
            if abs(p) < abs(0.5 * q * etemp) and p > q * (a - x) and \
                    p < q * (b - x):
                d = p / q
                u = x + d
                if (u - a) < tol2 or (b - u) < tol2:
                    d = tol1 if x < m else -tol1
                use_golden = False
        if use_golden:
            e = (b - x) if x < m else (a - x)
            d = golden * e
        u = x + d if abs(d) >= tol1 else x + (tol1 if d > 0 else -tol1)
        fu = float(f(u))
        if fu <= fx:
            if u < x:
                b = x
            else:
                a = x
            v, fv, w, fw, x, fx = w, fw, x, fx, u, fu
        else:
            if u < x:
                a = u
            else:
                b = u
            if fu <= fw or w == x:
                v, fv, w, fw = w, fw, u, fu
            elif fu <= fv or v == x or v == w:
                v, fv = u, fu
    return x, fx


def gcv_lambda(
    gcv_type,
    A,
    B,
    b,
    k_gcv: int = 20,
    lo: float = 1e-9,
    hi: float = 1e-1,
    tol: float = 1e-8,
    weight: float = 1.0,
    residual_space: str = "projected",
):
    """GCV-optimal lambda by bounded minimization on the projected problem:
    the reference's ``fminbnd(gcv_function(...), 1e-9, 1e-1)``
    (``analyze_regularization.m:39-46``) with the Arnoldi factored once.
    Returns ``(lam, gcv_value)`` as floats.

    ``residual_space="original"`` evaluates the numerator against the
    original data (recommended for 'ba', whose projected numerator vanishes
    as lam -> 0 and parks the minimizer at ``lo``)."""
    H, t, trace_dim, _, Q, A, b = _arnoldi_for(gcv_type, A, B, b, k_gcv)
    H, t, R, rhs = _float64(
        H, t, *_maybe_original(residual_space, gcv_type, A, b, Q, H))
    kdim = int(k_gcv)

    def g(lam):
        return gcv_from_H(H, t, lam, trace_dim, kdim, weight, R, rhs)

    return minimize_scalar_bounded(g, lo, hi, tol=tol)
