"""Morozov discrepancy-principle lambda selection on the projected problem
(PyTorch port).

Twin of ``hybrid_gmres_tpu/reg/discrepancy.py``.  No reference counterpart
(the reference selects lambda by GCV or by oracle sweeps); this is the
standard alternative when a noise-level estimate ``delta = ||e||`` is
available: pick the LARGEST lambda whose Tikhonov-regularized iterate still
fits the data to ``tau * delta`` (residuals increase monotonically with
lambda, so that is the crossing of ``||b - A x_lam|| = tau * delta``).

One Arnoldi factorization, then every grid lambda is solved on the
projected system in one batched call, and the candidates' true residuals
come from multi-RHS products (``A.matmat``, after ``B.matmat`` for "ab"):
on the card the redesigned K2 at R = the grid size, on a row-major block.
"""

from __future__ import annotations

import numpy as np
import torch

from hybrid_gmres_tpu_torch.krylov.arnoldi import arnoldi
from hybrid_gmres_tpu_torch.krylov.projected import projected_tikhonov_solve
from hybrid_gmres_tpu_torch.ops.linear_operator import as_operator, as_vector
from hybrid_gmres_tpu_torch.utils.device import scalar_tensor


def discrepancy_lambda(
    variant: str,
    A,
    B,
    b,
    delta,
    tau: float = 1.02,
    k: int = 20,
    lam_grid=None,
):
    """(lam, info): largest grid lambda with ``||b - A x_lam|| <= tau*delta``.

    ``variant``: "ab" (Krylov on A B, x = B Q y) or "ba" (Krylov on B A with
    r0 = B b, x = Q y).  Falls back to the smallest-residual lambda if no
    grid point satisfies the bound (delta too optimistic).  ``info`` carries
    the grid and residual curve for diagnostics.  Everything stays on the
    device: ``lam`` is a 0-d tensor.
    """
    b = as_vector(b)
    A = as_operator(A, device=b.device)
    B = as_operator(B, device=b.device)
    if lam_grid is None:
        lam_grid = np.logspace(-9, 0, 80)
    if variant == "ab":
        def mv(q):
            return A.matvec(B.matvec(q))
        r0 = b
    elif variant == "ba":
        def mv(q):
            return B.matvec(A.matvec(q))
        r0 = B.matvec(b)
    else:
        raise ValueError("variant must be 'ab' or 'ba'")
    k = int(k)
    Q, H, beta, nsteps = arnoldi(mv, r0, k, breakdown_tol=1e-12)
    t = torch.zeros((k + 1,), dtype=H.dtype, device=H.device)
    t[0] = beta
    grid = torch.as_tensor(lam_grid, dtype=H.dtype, device=H.device)
    L = grid.shape[0]

    ys = projected_tikhonov_solve(H.expand(L, -1, -1), t.expand(L, -1), grid,
                                  nsteps)                 # (L, k)
    X = Q[:, :k] @ ys.T                                   # (n_or_m, L)
    if variant == "ab":
        X = B.matmat(X)
    R = A.matmat(X)                                       # (m, L)
    res = torch.linalg.vector_norm(b[:, None] - R, dim=0)  # (L,)

    bound = scalar_tensor(tau, res.dtype, res.device) * scalar_tensor(
        delta, res.dtype, res.device)
    ok = res <= bound
    # largest feasible lambda; else the smallest-residual one
    idx_feasible = torch.where(ok, torch.arange(L, device=res.device),
                               -1).max()
    idx = torch.where(idx_feasible >= 0, idx_feasible, torch.argmin(res))
    return grid[idx], {"lam_grid": grid, "res": res, "feasible": ok,
                       "bound": bound, "nsteps": nsteps}
