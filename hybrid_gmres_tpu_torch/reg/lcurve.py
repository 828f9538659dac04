"""L-curve / error-vs-lambda sweeps for the hybrid solvers (PyTorch port).

Twin of ``hybrid_gmres_tpu/reg/lcurve.py``.  The reference sweeps 100
lambdas by re-running the solver per lambda
(``analyze_regularization.m:22-33``); the JAX package maps the single
solver over the grid with ``vmap``.  Here the grid is a loop over the same
single solver, so every lambda gets the numbers of a single solve: the
batched solvers are fused-only, and on ill-posed problems their
unregularized columns drift O(1) from looped singles as lambda -> 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hybrid_gmres_tpu_torch.ops.linear_operator import as_operator, as_vector
from hybrid_gmres_tpu_torch.solvers.gmres import ab_gmres, ba_gmres


class LCurveSweep(NamedTuple):
    lam_grid: torch.Tensor
    res_norms: torch.Tensor  # ||b - A x_lam|| / ||b||   (at final iteration)
    sol_norms: torch.Tensor  # ||x_lam||
    err_norms: torch.Tensor  # final relative error
    lam_true_opt: torch.Tensor  # argmin of err_norms
    err_min: torch.Tensor


def lcurve_sweep(
    variant: str,
    A,
    B,
    b,
    x_true,
    lam_grid,
    tol: float = 1e-6,
    maxit: int = 32,
) -> LCurveSweep:
    """Sweep a hybrid PTR solver over ``lam_grid``; returns L-curve data.
    One solve per lambda, queued without host reads.  ``lam_true_opt`` is
    the lambda of the smallest error that is not NaN."""
    b = as_vector(b)
    A = as_operator(A, device=b.device)
    B = as_operator(B, device=b.device)
    solver = {"ab": ab_gmres, "ba": ba_gmres}[variant]
    grid = torch.as_tensor(lam_grid).to(b.device)
    b_norm = torch.linalg.vector_norm(b)
    rows = []
    for lam in torch.as_tensor(lam_grid, dtype=torch.float64).tolist():
        r = solver(A, B, b, x_true, tol=tol, maxit=maxit, lam=lam)
        res = torch.linalg.vector_norm(b - A.matvec(r.x)) / b_norm
        sol = torch.linalg.vector_norm(r.x)
        # err_hist[niters - 1], read as the JAX package indexes it (a
        # negative index counts from the end)
        last = torch.remainder(r.niters - 1, r.err_hist.shape[0])
        err = r.err_hist.gather(0, last.long().reshape(1))[0]
        rows.append(torch.stack([res, sol, err]))
    res_norms, sol_norms, err_norms = torch.stack(rows, dim=1)
    # a NaN error (the float32 Cholesky of H'H + lam I fails at the
    # smallest lambdas of ill-posed problems) is no optimum: the JAX
    # package's argmin would return it
    idx = torch.argmin(torch.nan_to_num(err_norms, nan=float("inf")))
    return LCurveSweep(
        lam_grid=grid,
        res_norms=res_norms,
        sol_norms=sol_norms,
        err_norms=err_norms,
        lam_true_opt=grid[idx],
        err_min=err_norms[idx],
    )
