"""Regularize-then-project (RTP) hybrid GMRES variants (PyTorch port).

Twin of ``hybrid_gmres_tpu/solvers/rtp.py``.  Both build their Krylov space
on the *shifted* operator ``B A + lam I`` with ``d = B b`` (reference
``hybrid_ab_gmres_rtp.m:6-7``, despite the "ab" name — see SURVEY.md §2.3).
They differ in the inner solve:

  * BA-RTP: plain projected Hessenberg LS ``y = Hbar \\ (beta e1)``
    (``hybrid_ba_gmres_rtp.m:28-30``);
  * AB-RTP: a Tikhonov re-solve against the *original* A and b restricted to
    the Krylov basis, ``y = (AQ' AQ + lam I)^{-1} AQ' b``
    (``hybrid_ab_gmres_rtp.m:31-33``).

The repo's experimental point is PTR != RTP (``run_ptr_rtp_comparison.m``).

Both use ``residual="true"``: each step applies ``B A`` (two SpMVs), and
the true residual ``A x_k`` one more.  AB-RTP recomputes ``A Q`` at every
step as the JAX package does: one multi-RHS product (``A.matmat``, the
redesigned K2 on the card) of ``maxit`` columns of the column-major basis,
the columns past ``k`` masked to zero.
"""

from __future__ import annotations

import torch

from hybrid_gmres_tpu_torch.krylov.projected import (
    projected_gram_tikhonov_solve,
    projected_ls_solve,
)
from hybrid_gmres_tpu_torch.ops.linear_operator import as_operator, as_vector
from hybrid_gmres_tpu_torch.solvers.common import (
    GMRESResult,
    gmres_core,
    rel_error_fn,
    rel_residual_fn,
)
from hybrid_gmres_tpu_torch.utils.device import (
    full_float32_matmul,
    scalar_tensor,
)


def _setup(A, B, b, x_true, maxit):
    b = as_vector(b)
    A = as_operator(A, device=b.device)
    B = as_operator(B, device=b.device)
    if x_true is not None:
        x_true = torch.as_tensor(x_true, dtype=b.dtype, device=b.device)
    maxit = min(A.shape) if maxit is None else int(maxit)
    return A, B, b, x_true, maxit


def _shifted_ba_mv(A, B, lam, like):
    """``q -> B (A q) + lam q``: two SpMVs per application."""
    lam = scalar_tensor(lam, like.dtype, like.device)

    def mv(q):
        return B.matvec(A.matvec(q)) + lam * q

    return mv


def _run(A, B, b, x_true, tol, maxit, lam, history, breakdown_tol,
         project_solve):
    r0 = B.matvec(b)  # x0 = 0 => r0 = d - (BA + lam I) 0 = B b
    return gmres_core(
        krylov_mv=_shifted_ba_mv(A, B, lam, b),
        r0=r0,
        project_solve=project_solve,
        solution_fn=lambda Q, y: Q[:, :maxit] @ y,
        residual_fn=rel_residual_fn(A, b),
        error_fn=rel_error_fn(x_true),
        maxit=maxit,
        tol=tol,
        x_shape=A.shape[1],
        breakdown_tol=breakdown_tol,
        history=history,
    )


def ba_gmres_rtp(
    A,
    B,
    b,
    x_true=None,
    tol: float = 1e-6,
    maxit: int | None = None,
    lam=1e-3,
    history: bool = True,
    breakdown_tol: float = 0.0,
) -> GMRESResult:
    """BA-GMRES (RTP): Krylov on ``B A + lam I``, plain projected solve."""
    A, B, b, x_true, maxit = _setup(A, B, b, x_true, maxit)
    return _run(A, B, b, x_true, tol, maxit, lam, history, breakdown_tol,
                lambda H, Q, t, kdim: projected_ls_solve(H, t, kdim))


def ab_gmres_rtp(
    A,
    B,
    b,
    x_true=None,
    tol: float = 1e-6,
    maxit: int | None = None,
    lam=1e-3,
    history: bool = True,
    breakdown_tol: float = 0.0,
) -> GMRESResult:
    """AB-GMRES (RTP): Krylov on ``B A + lam I``; inner Tikhonov solve vs
    A, b."""
    A, B, b, x_true, maxit = _setup(A, B, b, x_true, maxit)
    idx = torch.arange(maxit, device=b.device)

    def project_solve(H, Q, t, kdim):
        mask = (idx < kdim).to(Q.dtype)
        # the elementwise product keeps the basis' column-major strides, so
        # the product reads the transposed view of an (maxit, n) tensor
        Qa = Q[:, :maxit] * mask[None, :]
        AQ = A.matmat(Qa)  # (m, maxit), columns >= kdim exactly zero
        # full float32 whatever the caller set: the Gram normal equations
        # square the conditioning (hybrid_ab_gmres_rtp.m:31-33)
        with full_float32_matmul():
            G = AQ.T @ AQ
            rhs = AQ.T @ b
        return projected_gram_tikhonov_solve(G, rhs, lam, kdim)

    return _run(A, B, b, x_true, tol, maxit, lam, history, breakdown_tol,
                project_solve)
