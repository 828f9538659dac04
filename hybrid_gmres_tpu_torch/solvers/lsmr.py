"""LSMR and hybrid LSMR.

Twin of ``hybrid_gmres_tpu/solvers/lsmr.py``.  Reference semantics:

  * LSMR: GKB plus two layers of plane rotations, O(1) memory
    (``lsmr_solver.m:32-77``); tracks the relative residual, the relative
    error, and the normal-equation residual ``||A^T r||`` history
    (``lsmr_solver.m:69-74``).
  * Hybrid LSMR: GKB with a *stored* right basis V and bidiagonal B_k; every
    iteration solves the Tikhonov-shifted projected LSMR normal equations
    ``[(B_k'B_k)^2 + (alpha_{k+1} beta_{k+1})^2 e e' + lam I] y
        = alpha_1 beta_1 (B_k'B_k) e_1``
    and sets ``x = V_k y`` (``hybrid_lsmr_solver.m:37-45``).

Faithfulness note: the reference's rank-1 term uses ``e_1 e_1^T`` where LSMR
theory calls for ``e_k e_k^T``.  The default is the correct
``rank1_mode="last"`` — which makes hybrid LSMR *exactly* equivalent to
hybrid BA-GMRES when ``B = A^T`` — and ``rank1_mode="first"`` is kept for
bug-compatible comparison.

As in ``solvers/lsqr.py`` the loops only queue work (no device value is read
on the host) and the stored bases are kept column by column and written in
place.  ``k`` is a host integer here, so the projected problem of step k is
solved on its leading ``kdim x kdim`` block instead of the JAX package's
``maxit``-padded one: the same numbers, and independent of ``maxit``, which
is what makes a resumed run equal the uninterrupted one bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from hybrid_gmres_tpu_torch.krylov.projected import (
    projected_gram_tikhonov_solve,
)
from hybrid_gmres_tpu_torch.solvers.common import (
    GKBResult,
    GKBState,
    global_norm,
    rel_error_fn,
    safe_normalize,
)
from hybrid_gmres_tpu_torch.solvers.lsqr import (
    check_reorth_carry,
    prepare_inputs,
    purify,
    resumed_histories,
    stored_basis,
)
from hybrid_gmres_tpu_torch.utils.checkpoint import (
    check_fingerprint,
    resume_fingerprint,
)


def operator_fro_norm(A, fro_norm, like):
    """``||A||_F`` for LSMR's ``ar_hist``: the caller's value, else the one
    the operator recorded (``BlockELLOperator`` stores it at ``from_csr``
    time), else that of a dense ``.mat``, else NaN for a matrix-free
    operator."""
    if fro_norm is None:
        fro_norm = getattr(A, "fro_norm", None)
    if fro_norm is None:
        mat = getattr(A, "mat", None)
        fro_norm = float("nan") if mat is None else torch.linalg.norm(mat)
    return torch.as_tensor(fro_norm, dtype=like.dtype, device=like.device)


def lsmr(A, b, x_true=None, tol: float = 1e-6, maxit: int | None = None,
         fro_norm=None, reorth: bool = False, resume_from=None,
         x0=None) -> GKBResult:
    """Standard LSMR (GKB + double QR recurrences).

    ``reorth=True`` fully reorthogonalizes the GKB bases (O(maxit (m+n))
    memory) — restores exact-arithmetic equivalence with BA-GMRES (B=A^T) to
    final iterations on ill-conditioned operators.
    ``resume_from``: a prior result's ``.state`` (same ``reorth``) — the
    recurrence continues with the larger ``maxit`` budget, reproducing an
    uninterrupted run exactly.
    ``x0``: optional warm start — the GKB runs on ``b - A x0`` with the
    iterate carried in x-space (``x = x0 + d``); the true residual/err/
    ``ar_hist`` records need no remapping.  Pass the same ``x0`` when
    resuming.  Multi-RHS serving twin: ``lsmr_batched``.

    Each step applies ``A`` and ``A^T`` a second time, for the true
    residual and ``||A^T r||``."""
    A, b, x_true, x0, maxit = prepare_inputs(A, b, x_true, x0, maxit)
    fp = resume_fingerprint(x0, None, device=b.device)   # before the loop
    if resume_from is not None:
        check_fingerprint(resume_from, x0, None)
    return _lsmr_core(A, b, x0, torch.linalg.vector_norm(b),
                      operator_fro_norm(A, fro_norm, b),
                      rel_error_fn(x_true), maxit, tol, reorth, resume_from,
                      fp)


def _lsmr_core(A, b, x0, b_norm, fro_norm, error_fn, maxit, tol, reorth,
               resume_from, fp, reduce=None, reduce_v=None):
    """The LSMR recurrence on ``A`` from the iterate ``x0`` (None: zero),
    as :func:`lsmr` documents it; returns the :class:`GKBResult`.
    ``reduce``: the sum over a mesh when ``A`` acts on this rank's slabs of
    sharded vectors (``parallel/sharded_gkb.py``): every norm and
    purification pass then reduces over it.  ``reduce_v``: the v-space's
    sum where it differs from the u-space's ``reduce`` (the 2-D mesh)."""
    rv = reduce if reduce_v is None else reduce_v
    dtype, device = b.dtype, b.device
    like = dict(dtype=dtype, device=device)
    eps = torch.finfo(dtype).eps
    n = A.shape[1]

    k0, res_hist, err_hist = resumed_histories(resume_from, maxit, b)
    ar_hist = torch.full((maxit,), float("nan"), **like)
    Ub = Vb = None
    if resume_from is None:
        b_iter = b if x0 is None else b - A.matvec(x0)
        u, beta1, _ = safe_normalize(b_iter, reduce)
        v, alpha1, _ = safe_normalize(A.rmatvec(u), rv)
        x = torch.zeros((n,), **like) if x0 is None else x0
        h, hbar = v, torch.zeros((n,), **like)
        one = torch.ones((), **like)
        alpha, zetabar, alphabar = alpha1, alpha1 * beta1, alpha1
        rho, rhobar, cbar, sbar = one, one, one, torch.zeros((), **like)
        active = torch.ones((), dtype=torch.bool, device=device)
        niters = torch.zeros((), dtype=torch.int32, device=device)
        if reorth:
            Ub = stored_basis(u, maxit + 1)
            Vb = stored_basis(v, maxit + 1)
    else:
        carry = resume_from.carry
        check_reorth_carry(carry, reorth, 14)
        (x, u, v, h, hbar, alpha, zetabar, alphabar, rho, rhobar, cbar, sbar,
         active, niters) = carry[:14]
        active, niters = active.to(torch.bool), niters.to(torch.int32)
        ar_hist[:k0] = resume_from.ar_hist
        if reorth:
            Ub = stored_basis(None, maxit + 1, carry[14])
            Vb = stored_basis(None, maxit + 1, carry[15])
    nan = torch.full((), float("nan"), **like)

    for k in range(k0, maxit):
        uhat = A.matvec(v) - alpha * u
        if reorth:
            uhat = purify(Ub[:k + 1], uhat, reduce)
        u_n, beta_k, ok_u = safe_normalize(uhat, reduce)
        vhat = A.rmatvec(u_n) - beta_k * v
        if reorth:
            vhat = purify(Vb[:k + 1], vhat, rv)
        v_n, alpha_n, ok_v = safe_normalize(vhat, rv)

        alphahat = alphabar
        rhoold = rho
        rho_n = torch.hypot(alphahat, beta_k)
        c = alphahat / rho_n
        s = beta_k / rho_n

        thetanew = s * alpha_n
        alphabar_n = c * alpha_n

        rhobarold = rhobar
        thetabar = sbar * rho_n
        rhobar_n = torch.hypot(cbar * rho_n, thetanew)
        cbar_n = (cbar * rho_n) / rhobar_n
        sbar_n = thetanew / rhobar_n

        zeta = cbar_n * zetabar
        zetabar_n = -sbar_n * zetabar

        # At k=1 thetabar = 0 so this reduces to hbar = h, matching the
        # reference's explicit first-iteration branch (lsmr_solver.m:56-60).
        hbar_n = h - (thetabar * rho_n) / (rhoold * rhobarold) * hbar
        x_n = x + (zeta / (rho_n * rhobar_n)) * hbar_n
        h_n = v_n - (thetanew / rho_n) * h

        r = b - A.matvec(x_n)
        r_norm = global_norm(r, reduce)
        res_k = r_norm / (b_norm + eps)
        ar_k = global_norm(A.rmatvec(r), rv) / (
            fro_norm * torch.clamp(r_norm, min=eps))
        err_k = error_fn(x_n)

        adopt = active & ok_u & ok_v
        x = torch.where(adopt, x_n, x)
        u = torch.where(adopt, u_n, u)
        v = torch.where(adopt, v_n, v)
        h = torch.where(adopt, h_n, h)
        hbar = torch.where(adopt, hbar_n, hbar)
        if reorth:
            Ub[k + 1] = torch.where(adopt, u_n, Ub[k + 1])
            Vb[k + 1] = torch.where(adopt, v_n, Vb[k + 1])
        alpha = torch.where(adopt, alpha_n, alpha)
        zetabar = torch.where(adopt, zetabar_n, zetabar)
        alphabar = torch.where(adopt, alphabar_n, alphabar)
        rho = torch.where(adopt, rho_n, rho)
        rhobar = torch.where(adopt, rhobar_n, rhobar)
        cbar = torch.where(adopt, cbar_n, cbar)
        sbar = torch.where(adopt, sbar_n, sbar)
        res_hist[k] = torch.where(adopt, res_k, nan)
        err_hist[k] = torch.where(adopt, err_k, nan)
        ar_hist[k] = torch.where(adopt, ar_k, nan)
        niters = torch.where(adopt, k + 1, niters)
        active = adopt & (res_k >= tol)

    carry = (x, u, v, h, hbar, alpha, zetabar, alphabar, rho, rhobar, cbar,
             sbar, active, niters, None if Ub is None else Ub.T,
             None if Vb is None else Vb.T)
    state = GKBState(carry=carry, res_hist=res_hist, err_hist=err_hist,
                     ar_hist=ar_hist, fp=fp)
    return GKBResult(x=x, err_hist=err_hist, res_hist=res_hist,
                     niters=niters, ar_hist=ar_hist, state=state)


def _hybrid_lsmr_projected(Bmat, alpha_next, beta_k, ab1, lam, kdim,
                           rank1_mode, rhs_offset=None):
    """The per-iteration shifted projected LSMR solve
    (``hybrid_lsmr_solver.m:37-45``) on the leading block of the padded
    bidiagonal: LHS ``(B'B)^2 + (alpha beta)^2 ee' + lam I``, RHS ``alpha1
    beta1 (B'B) e1`` — shared by the loop body and the resume patch.
    ``rhs_offset``: optional (kdim,) linear term added to the RHS (the
    warm-start ``x0_reg="full"`` mode's ``-lam V^T x0``).  Returns ``y``
    (kdim,)."""
    Bk = Bmat[:kdim + 1, :kdim]
    BtB = Bk.T @ Bk
    G = BtB @ BtB
    e_idx = kdim - 1 if rank1_mode == "last" else 0
    G[e_idx, e_idx] += (alpha_next * beta_k) ** 2
    rhs = ab1 * BtB[:, 0]
    if rhs_offset is not None:
        rhs = rhs + rhs_offset
    return projected_gram_tikhonov_solve(G, rhs, lam, kdim)


def make_hybrid_lsmr_lam_fn(lam, gcv_grid, n, maxit, dtype, device):
    """Lambda-selection strategy of hybrid LSMR: scalar passthrough, or the
    HyBR-style per-iteration GCV pick on the projected bidiagonal problem
    (two SVDs of the padded (maxit+1, maxit) ``Bmat`` per call, then every
    grid point at O(k)).  Returns ``lam_fn(Bmat_k, kdim, b_norm)``."""
    if not isinstance(lam, str):
        return lambda Bmat_k, kdim, b_norm: lam
    if lam != "gcv":
        raise ValueError("lam must be a scalar or 'gcv'")
    from hybrid_gmres_tpu_torch.reg.gcv import gcv_grid_lambda

    grid = torch.as_tensor(
        np.logspace(-8, -1, 50) if gcv_grid is None else gcv_grid,
        dtype=dtype, device=device)

    def lam_fn(Bmat_k, kdim, b_norm):
        t = torch.zeros((maxit + 1,), dtype=dtype, device=device)
        t[0] = b_norm
        return gcv_grid_lambda(Bmat_k, t, kdim, grid, n)

    return lam_fn


def hybrid_lsmr(A, b, x_true=None, tol: float = 1e-6,
                maxit: int | None = None, lam=1e-3,
                rank1_mode: str = "last", reorth: bool = False,
                resume_from=None, gcv_grid=None, x0=None,
                x0_reg: str = "correction") -> GKBResult:
    """Hybrid LSMR: stored-basis GKB + per-iteration shifted projected solve.

    ``lam``: scalar, or ``"gcv"`` for HyBR-style per-iteration adaptive
    selection — at every k the lambda minimizing the GCV functional of the
    projected bidiagonal Tikhonov problem ``min ||B_k y - beta_1 e_1||``
    over ``gcv_grid``.

    ``reorth=True`` fully reorthogonalizes both GKB bases (CGS2 against the
    stored U/V) — holds the hybrid BA-GMRES == hybrid LSMR equivalence to
    FULL history depth on ill-conditioned operators.

    ``x0``: optional warm start — GKB runs on ``b - A x0`` with
    ``x = x0 + V y``.  ``x0_reg`` picks the regularizer semantics:

      * ``"correction"`` (default): Tikhonov acts on the CORRECTION,
        ``lam ||y||^2`` — the semantics of the hybrid GMRES solvers' warm
        start;
      * ``"full"``: Tikhonov acts on the full iterate restricted to the
        affine search space, ``lam ||x0 + V y||^2`` — the projected RHS
        gains ``-lam V^T x0``.

    ``resume_from``: a prior result's ``.state`` (same ``lam`` /
    ``rank1_mode`` / ``reorth`` / ``x0``).  The reference holds a stale
    alpha at its final iteration (``hybrid_lsmr_solver.m:26-33``, a
    maxit-dependent artifact); the checkpoint carries the *advanced*
    recurrence and the resume re-solves that entry under non-final
    semantics, so ``resume(run(k), K) == run(K)`` exactly, including
    entry ``k-1``.
    """
    if rank1_mode not in ("last", "first"):
        raise ValueError("rank1_mode must be 'last' (textbook) or 'first' "
                         "(reference-compat)")
    if x0_reg not in ("correction", "full"):
        raise ValueError("x0_reg must be 'correction' or 'full'")
    A, b, x_true, x0, maxit = prepare_inputs(A, b, x_true, x0, maxit)
    base_error_fn = rel_error_fn(x_true)
    have_x0 = x0 is not None
    b_iter = b - A.matvec(x0) if have_x0 else b
    error_fn = ((lambda d: base_error_fn(x0 + d)) if have_x0
                else base_error_fn)
    # the tag makes an x0_reg-mismatched resume raise (the two semantics
    # produce different histories for the same x0/lam)
    tag = x0_reg if (have_x0 and x0_reg == "full") else ""
    # before the loop, as in lsqr()
    fp = resume_fingerprint(x0, lam, tag=tag, device=b.device)
    if resume_from is not None:
        check_fingerprint(resume_from, x0, lam, tag=tag)
    lam_fn = make_hybrid_lsmr_lam_fn(lam, gcv_grid, A.shape[1], maxit,
                                     b.dtype, b.device)
    d, state = _hybrid_lsmr_core(
        A, b, b_iter, torch.linalg.vector_norm(b), error_fn, lam_fn,
        maxit, tol, rank1_mode, reorth, resume_from,
        x0 if have_x0 and x0_reg == "full" else None, fp)
    return GKBResult(x=x0 + d if have_x0 else d,
                     err_hist=state.err_hist, res_hist=state.res_hist,
                     niters=state.carry[7], state=state)


def _hybrid_lsmr_core(A, b, b_iter, b_norm, error_fn, lam_fn, maxit, tol,
                      rank1_mode, reorth, resume_from, x0_full, fp,
                      reduce=None, reduce_v=None):
    """The hybrid LSMR recurrence on ``A`` for the correction ``d`` of
    ``b_iter`` (``b - A x0``), as :func:`hybrid_lsmr` documents it.
    ``x0_full``: the warm start of ``x0_reg="full"`` (else None).  Returns
    ``(d, state)``.  ``reduce``: the sum over a mesh when ``A`` acts on
    this rank's slabs of sharded vectors (``parallel/sharded_gkb.py``);
    ``reduce_v``: the v-space's where it differs (the 2-D mesh)."""
    rv = reduce if reduce_v is None else reduce_v
    dtype, device = b.dtype, b.device
    like = dict(dtype=dtype, device=device)
    n = A.shape[1]

    def roff(Vk, lam_k):
        # x0_reg="full": regularize ||x0 + V y||^2 -> RHS -= lam V^T x0
        if x0_full is None:
            return None
        c = Vk @ x0_full
        return -lam_k * (c if rv is None else rv(c))

    def solve_at(Bmat_k, alpha_next, beta_k, kdim):
        """The iterate of step ``kdim`` and its records."""
        lam_k = lam_fn(Bmat_k, kdim, b_norm)
        Vk = Vb[:kdim]
        y = _hybrid_lsmr_projected(Bmat_k, alpha_next, beta_k, ab1, lam_k,
                                   kdim, rank1_mode,
                                   rhs_offset=roff(Vk, lam_k))
        x_k = Vk.T @ y
        res_k = global_norm(b_iter - A.matvec(x_k), reduce) / b_norm
        return x_k, res_k, error_fn(x_k)

    k0, res_hist, err_hist = resumed_histories(resume_from, maxit, b)
    Ub = None
    if resume_from is None:
        u, beta1, _ = safe_normalize(b_iter, reduce)
        v, alpha, _ = safe_normalize(A.rmatvec(u), rv)
        Vb = stored_basis(v, maxit)
        Bmat = torch.zeros((maxit + 1, maxit), **like)
        x = torch.zeros((n,), **like)
        if reorth:
            Ub = stored_basis(u, maxit + 1)
        active = torch.ones((), dtype=torch.bool, device=device)
        niters = torch.zeros((), dtype=torch.int32, device=device)
        ab1 = alpha * beta1
    else:
        x, u, v, Vp, Bp, alpha, active, niters, Up, ab1 = resume_from.carry
        if bool(Up.numel()) != bool(reorth):
            raise ValueError("resume_from state does not match reorth=; "
                             "pass the same reorth as the original run")
        niters = niters.to(torch.int32)
        Vb = stored_basis(None, maxit, Vp)
        extra = maxit - Bp.shape[1]
        Bmat = torch.nn.functional.pad(Bp, (0, extra, 0, extra))
        if reorth:
            Ub = stored_basis(None, maxit + 1, Up)
        if k0 > 0:
            # Re-solve entry k0-1 under NON-final semantics (the carried
            # alpha is the advanced one): exactly what an uninterrupted run
            # records at that iteration.  The checkpointed run could not
            # write v_{k0+1} into V (its V had only k0 columns); the
            # uninterrupted run puts it at column k0, and the carried v IS
            # that vector.
            did = torch.isfinite(res_hist[k0 - 1])
            Vb[k0] = torch.where(did, v, Vb[k0])
            x_p, res_p, err_p = solve_at(Bmat, alpha, Bmat[k0, k0 - 1], k0)
            x = torch.where(did, x_p, x)
            res_hist[k0 - 1] = torch.where(did, res_p, res_hist[k0 - 1])
            err_hist[k0 - 1] = torch.where(did, err_p, err_hist[k0 - 1])
            # the uninterrupted run's post-iteration active flag: adopted
            # there iff adopted here, continuing iff the re-solved residual
            # is still above tol
            active = did & (res_p > tol)
    nan = torch.full((), float("nan"), **like)

    for k in range(k0, maxit):
        kdim = k + 1
        Bmat_n = Bmat.clone()
        Bmat_n[k, k] = alpha
        uhat = A.matvec(v) - alpha * u
        if reorth:
            uhat = purify(Ub[:kdim], uhat, reduce)
        u_n, beta_k, ok_u = safe_normalize(uhat, reduce)
        Bmat_n[k + 1, k] = beta_k

        # The carry always ADVANCES the right recurrence (so a checkpoint
        # can continue exactly); the reference's stale-alpha final-iteration
        # REPORTING (hybrid_lsmr_solver.m:26-33) is recovered below.
        vhat = A.rmatvec(u_n) - beta_k * v
        if reorth:
            vhat = purify(Vb[:kdim], vhat, rv)
        v2, alpha2, ok2 = safe_normalize(vhat, rv)
        adv = k < maxit - 1
        alpha_rep = alpha2 if adv else alpha        # stale at final iter
        adopt = active & ok_u & (ok2 if adv else True)
        if adv:
            # When the step is not adopted the iterate computed below from
            # the unchanged column is discarded, so masking the write is
            # the whole of the JAX select over V.
            Vb[kdim] = torch.where(adopt, v2, Vb[kdim])
        if reorth:
            Ub[kdim] = torch.where(adopt, u_n, Ub[kdim])

        x_n, res_k, err_k = solve_at(Bmat_n, alpha_rep, beta_k, kdim)

        x = torch.where(adopt, x_n, x)
        u = torch.where(adopt, u_n, u)
        v = torch.where(adopt, v2, v)
        Bmat = torch.where(adopt, Bmat_n, Bmat)
        alpha = torch.where(adopt, alpha2, alpha)
        res_hist[k] = torch.where(adopt, res_k, nan)
        err_hist[k] = torch.where(adopt, err_k, nan)
        niters = torch.where(adopt, kdim, niters)
        active = adopt & (res_k > tol)

    U_out = Ub.T if reorth else torch.zeros((0, 0), **like)
    carry = (x, u, v, Vb.T, Bmat, alpha, active, niters, U_out, ab1)
    return x, GKBState(carry=carry, res_hist=res_hist, err_hist=err_hist,
                       fp=fp)
