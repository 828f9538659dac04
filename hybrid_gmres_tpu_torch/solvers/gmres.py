"""AB-GMRES and BA-GMRES, non-hybrid and hybrid (PyTorch port).

Twin of ``hybrid_gmres_tpu/solvers/gmres.py``:
  * AB-GMRES: Arnoldi on ``M = A B`` in m-space, ``x = B (Q_k y)``;
  * BA-GMRES: Arnoldi on ``M = B A`` in n-space with ``r0 = B b``,
    ``x = Q_k y``;
  * hybrid (PTR): the projected problem is Tikhonov-regularized,
    ``y = (Hbar'Hbar + lam I)^{-1} Hbar' (beta e1)``.

``lam=None`` gives the non-hybrid variant, a scalar the hybrid one,
``lam="gcv"`` the per-iteration GCV-optimal lambda over a grid.
``ba_gmres_restarted`` / ``ab_gmres_restarted`` chain warm-started cycles
of a fixed budget on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from hybrid_gmres_tpu_torch.krylov.projected import (
    projected_ls_solve,
    projected_tikhonov_solve,
)
from hybrid_gmres_tpu_torch.ops.linear_operator import (
    as_operator,
    as_vector,
)
from hybrid_gmres_tpu_torch.solvers.common import (
    FusedResidual,
    GMRESResult,
    gmres_core,
    rel_error_fn,
    rel_residual_fn,
)
from hybrid_gmres_tpu_torch.utils.checkpoint import (
    check_fingerprint,
    resume_fingerprint,
)


def _make_project_solve(lam, trace_dim, gcv_grid):
    """Projected-solve strategy: None -> plain LS; scalar (or a per-RHS
    tensor) -> fixed-lambda Tikhonov; "gcv" -> at every iteration the grid
    lambda minimizing the GCV functional of the CURRENT projected problem
    (two SVDs per problem, O(k) per grid point).

    The returned ``solve(H, Q, t, kdim)`` takes leading batch dimensions on
    ``H`` and ``t`` (see ``krylov/projected.py``)."""
    if lam is None:
        return lambda H, Q, t, kdim: projected_ls_solve(H, t, kdim)
    if isinstance(lam, str):
        if lam != "gcv":
            raise ValueError("lam must be None, a scalar, or 'gcv'")
        from hybrid_gmres_tpu_torch.reg.gcv import gcv_grid_lambda

        if gcv_grid is None:
            gcv_grid = np.logspace(-8, -1, 50)

        def solve(H, Q, t, kdim):
            grid = torch.as_tensor(gcv_grid, dtype=H.dtype, device=H.device)
            lam_k = gcv_grid_lambda(H, t, kdim, grid, trace_dim)
            return projected_tikhonov_solve(H, t, lam_k, kdim)

        return solve
    return lambda H, Q, t, kdim: projected_tikhonov_solve(H, t, lam, kdim)


def _basis(Q, maxit, y):
    """The first ``maxit`` basis columns in ``y``'s dtype: a basis stored
    in bf16 (``basis_dtype``) is read upcast, exactly."""
    return Q[:, :maxit].to(y.dtype)


def _setup(A, B, b, x_true, x0, maxit, lam, trace_axis, gcv_grid,
           resume_from=None):
    if resume_from is not None:
        check_fingerprint(resume_from, x0, lam)
    b = as_vector(b)
    A = as_operator(A, device=b.device)
    B = as_operator(B, device=b.device)
    if x_true is not None:
        x_true = torch.as_tensor(x_true, dtype=b.dtype, device=b.device)
    if x0 is not None:
        x0 = torch.as_tensor(x0, dtype=b.dtype, device=b.device)
    maxit = min(A.shape) if maxit is None else int(maxit)
    return A, B, b, x_true, x0, maxit, _make_project_solve(
        lam, A.shape[trace_axis], gcv_grid)


def _offset(x0, y):
    """``x0`` shaped to add to ``Q @ y`` for a vector or a matrix ``y``."""
    return x0 if y.ndim == 1 else x0[:, None]


def ab_gmres(
    A,
    B,
    b,
    x_true=None,
    tol: float = 1e-6,
    maxit: int | None = None,
    lam=None,
    history: bool = True,
    breakdown_tol: float = 0.0,
    gcv_grid=None,
    resume_from: GMRESResult | None = None,
    x0=None,
    residual: str = "true",
    defer_histories: bool = False,
    basis_dtype=None,
) -> GMRESResult:
    """AB-GMRES: Krylov space in m-space on ``M = A B``; ``x = B Q_k y``.

    ``lam``: None (non-hybrid LS), scalar (hybrid PTR), or "gcv"
    (per-iteration GCV-optimal lambda over ``gcv_grid``).
    ``x0``: optional initial iterate (``r0 = b - A x0``, ``x = x0 + B Q_k
    y``).  ``residual="fused"`` stores ``B q_k`` and ``A (B q_k)`` so the
    per-iteration solution and TRUE residual are small matmuls — 2
    SpMVs/iteration instead of 4, identical numbers.
    ``defer_histories`` and ``basis_dtype`` (fused only), ``history`` and
    ``resume_from``: see ``solvers/common.py:gmres_core``.  When resuming a
    run that used ``x0``, pass the same ``x0`` (and ``lam``) again: the
    checkpoint's fingerprint is checked against them.
    """
    A, B, b, x_true, x0, maxit, project_solve = _setup(
        A, B, b, x_true, x0, maxit, lam, 0, gcv_grid, resume_from)

    def krylov_mv(q):
        return A.matvec(B.matvec(q))

    if x0 is None:
        r0 = b

        def solution_fn(Q, y):
            return B.matvec(_basis(Q, maxit, y) @ y)
    else:
        r0 = b - A.matvec(x0)

        def solution_fn(Q, y):
            return x0 + B.matvec(_basis(Q, maxit, y) @ y)
    fused = (
        FusedResidual(first_mv=B.matvec, second_mv=A.matvec, rhs=r0,
                      rhs_norm=torch.linalg.vector_norm(b), img="second",
                      solution_from_image=True, x_offset=x0)
        if residual == "fused" else None
    )
    res = gmres_core(
        krylov_mv=krylov_mv,
        r0=r0,
        project_solve=project_solve,
        solution_fn=solution_fn,
        residual_fn=rel_residual_fn(A, b),
        error_fn=rel_error_fn(x_true),
        maxit=maxit,
        tol=tol,
        x_shape=A.shape[1],
        breakdown_tol=breakdown_tol,
        history=history,
        resume_from=resume_from,
        x_init=x0,
        residual=residual,
        fused=fused,
        defer_histories=defer_histories,
        basis_dtype=basis_dtype,
    )
    return res._replace(fp=resume_fingerprint(x0, lam, device=b.device))


def ba_gmres(
    A,
    B,
    b,
    x_true=None,
    tol: float = 1e-6,
    maxit: int | None = None,
    lam=None,
    history: bool = True,
    breakdown_tol: float = 0.0,
    gcv_grid=None,
    resume_from: GMRESResult | None = None,
    x0=None,
    residual: str = "true",
    defer_histories: bool = False,
    basis_dtype=None,
) -> GMRESResult:
    """BA-GMRES: Krylov space in n-space on ``M = B A`` with ``r0 = B b``.

    ``lam``, ``gcv_grid`` and ``defer_histories`` as in :func:`ab_gmres`.
    ``x0``: optional initial iterate (``r0 = B (b - A x0)``, ``x = x0 + Q_k
    y``).  ``residual="fused"`` stores ``A q_k`` so the TRUE residual needs
    no extra SpMV: 2 SpMVs per iteration.
    """
    A, B, b, x_true, x0, maxit, project_solve = _setup(
        A, B, b, x_true, x0, maxit, lam, 1, gcv_grid, resume_from)

    def krylov_mv(q):
        return B.matvec(A.matvec(q))

    if x0 is None:
        rhs = b

        def solution_fn(Q, y):
            return _basis(Q, maxit, y) @ y
    else:
        rhs = b - A.matvec(x0)

        def solution_fn(Q, y):
            return _offset(x0, y) + _basis(Q, maxit, y) @ y
    r0 = B.matvec(rhs)
    fused = (
        FusedResidual(first_mv=A.matvec, second_mv=B.matvec, rhs=rhs,
                      rhs_norm=torch.linalg.vector_norm(b), img="first")
        if residual == "fused" else None
    )
    res = gmres_core(
        krylov_mv=krylov_mv,
        r0=r0,
        project_solve=project_solve,
        solution_fn=solution_fn,
        residual_fn=rel_residual_fn(A, b),
        error_fn=rel_error_fn(x_true),
        maxit=maxit,
        tol=tol,
        x_shape=A.shape[1],
        breakdown_tol=breakdown_tol,
        history=history,
        resume_from=resume_from,
        x_init=x0,
        residual=residual,
        fused=fused,
        defer_histories=defer_histories,
        basis_dtype=basis_dtype,
    )
    return res._replace(fp=resume_fingerprint(x0, lam, device=b.device))


def _restarted(run_cycle, max_restarts, tol) -> GMRESResult:
    """Outer restart loop: chain ``x0`` through cycles and join the
    histories so that the result reads like one long run.  ``run_cycle(x0)``
    runs one warm-started cycle.  Reads ``niters`` and the cycle's last
    residual on the host once per cycle.

    The result is NOT resumable (``niters`` counts all cycles but ``Q``/``H``
    hold only the last cycle's factorization; ``check_resumable`` rejects
    it): to continue, warm-start a fresh solve from ``.x``."""
    x0 = None
    res_hists, err_hists = [], []
    total_iters = 0
    last = None
    for _ in range(int(max_restarts)):
        r = run_cycle(x0)
        k = int(r.niters)
        res_hists.append(r.res_hist[:k])
        err_hists.append(r.err_hist[:k])
        total_iters += k
        x0 = r.x
        last = r
        if k == 0:
            break  # breakdown or zero RHS: no progress possible
        last_res = float(r.res_hist[k - 1])
        if np.isnan(last_res) or last_res <= tol:
            break
    return GMRESResult(
        x=last.x,
        err_hist=torch.cat(err_hists),
        res_hist=torch.cat(res_hists),
        niters=torch.tensor(total_iters, dtype=torch.int32,
                            device=last.x.device),
        Q=last.Q,
        H=last.H,
        beta=last.beta,
        # the last cycle's stop state (a >1-cycle aggregate is rejected by
        # check_resumable regardless)
        active=last.active,
    )


def ba_gmres_restarted(
    A,
    B,
    b,
    x_true=None,
    tol: float = 1e-6,
    restart: int = 20,
    max_restarts: int = 10,
    lam=None,
    residual: str = "true",
) -> GMRESResult:
    """Restarted BA-GMRES(restart): cycles of ``restart`` steps, each
    warm-started from the last (``r0 = B (b - A x0)``, ``x = x0 + Q_k y``),
    until ``max_restarts`` cycles ran or the residual reached ``tol``."""
    return _restarted(
        lambda x0: ba_gmres(A, B, b, x_true, tol=tol, maxit=int(restart),
                            lam=lam, x0=x0, residual=residual),
        max_restarts, tol)


def ab_gmres_restarted(
    A,
    B,
    b,
    x_true=None,
    tol: float = 1e-6,
    restart: int = 20,
    max_restarts: int = 10,
    lam=None,
    residual: str = "true",
) -> GMRESResult:
    """Restarted AB-GMRES(restart): Krylov in m-space, warm-started via
    ``r0 = b - A x0``, ``x = x0 + B Q_k y`` per cycle."""
    return _restarted(
        lambda x0: ab_gmres(A, B, b, x_true, tol=tol, maxit=int(restart),
                            lam=lam, x0=x0, residual=residual),
        max_restarts, tol)
