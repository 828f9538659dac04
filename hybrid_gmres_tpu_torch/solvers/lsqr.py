"""LSQR and hybrid LSQR (Golub–Kahan bidiagonalization + Givens recurrences).

Twin of ``hybrid_gmres_tpu/solvers/lsqr.py``.  Reference semantics:

  * LSQR: O(1)-memory GKB with a single Givens recurrence
    (``lsqr_solver.m:20-47``).  The per-iteration residual history uses the
    cheap estimate ``|phi_bar| / ||b||`` and the final entry is patched with
    the true residual at exit (``lsqr_solver.m:44,52``).
  * Hybrid LSQR: plain LSQR on the Tikhonov-augmented system
    ``[A; sqrt(lam) I] x ~= [b; 0]`` (``hybrid_lsqr_solver.m:5-6``), with the
    residual tracked every iteration against the *unaugmented* system
    (``hybrid_lsqr_solver.m:43``).

The GKB transpose product goes through ``op.rmatvec``; on the block-ELL
operators that is kernel K3 on the forward panel, or K1 on an adjoint panel.

The JAX ``lax.scan`` is a fixed-trip Python loop that only queues work:
``active``, ``niters`` and the breakdown flags stay device tensors combined
with ``torch.where``, so a breakdown freezes the carry and records NaN
without the host ever reading a device value.  The stored bases of
``reorth=True`` are kept column by column (a column write and the
purification products touch contiguous memory), written in place, and handed
out as views in the JAX axis order (space, maxit+1).
"""

from __future__ import annotations

import torch

from hybrid_gmres_tpu_torch.ops.linear_operator import (
    AugmentedOperator,
    as_operator,
    as_vector,
)
from hybrid_gmres_tpu_torch.solvers.common import (
    GKBResult,
    GKBState,
    inner,
    rel_error_fn,
    safe_normalize,
)
from hybrid_gmres_tpu_torch.utils.checkpoint import (
    check_fingerprint,
    resume_fingerprint,
)
from hybrid_gmres_tpu_torch.utils.device import scalar_tensor


def purify(basis_rows, vec, reduce=None):
    """Two CGS passes of ``vec`` against the basis vectors stored as the
    rows of ``basis_rows`` (k, space): plain dense products.  ``reduce``:
    for a sharded basis, the sum over the mesh of each pass's coefficients
    (one fused collective per pass; a ``common.SplitSum`` for a space
    sharded in two parts, one per part)."""
    for _ in range(2):
        vec = vec - basis_rows.T @ inner(basis_rows, vec, reduce)
    return vec


def stored_basis(first, ncols, prior=None):
    """Zero basis of ``ncols`` vectors kept as rows (column-major in the JAX
    axis order), holding ``first`` in slot 0 or, on a resume, the columns of
    ``prior`` (space, k): an own copy, since the loop writes in place."""
    space = first.shape[0] if prior is None else prior.shape[0]
    like = first if prior is None else prior
    rows = torch.zeros((ncols, space), dtype=like.dtype, device=like.device)
    if prior is None:
        rows[0] = first
    else:
        rows[:prior.shape[1]] = prior.T
    return rows


def resumed_histories(resume_from, maxit, like, tail=()):
    """NaN histories ``(maxit,) + tail`` in the dtype and on the device of
    ``like``, holding the checkpoint's records; returns ``(k0, res_hist,
    err_hist)``."""
    res = torch.full((maxit,) + tuple(tail), float("nan"), dtype=like.dtype,
                     device=like.device)
    err = res.clone()
    if resume_from is None:
        return 0, res, err
    k0 = resume_from.res_hist.shape[0]
    if k0 >= maxit:
        raise ValueError(f"resume needs maxit > {k0}")
    res[:k0] = resume_from.res_hist
    err[:k0] = resume_from.err_hist
    return k0, res, err


def check_reorth_carry(carry, reorth, idx):
    """A resumed carry must hold stored bases exactly when ``reorth``."""
    has = len(carry) > idx and carry[idx] is not None
    if has != bool(reorth):
        raise ValueError("resume_from state does not match reorth=; pass "
                         "the same reorth as the original run")


def patch_true_residual(res_hist, niters, true_res):
    """The last recorded entry replaced by the true residual
    (``lsqr_solver.m:52``); nothing when no iteration was ever adopted
    (``niters == 0`` must not wrap the index).  ``res_hist`` (maxit,) with
    0-dim ``niters``, or (maxit, R) with (R,) ``niters``."""
    slot = torch.clamp(niters - 1, min=0)
    ks = torch.arange(res_hist.shape[0], device=res_hist.device)
    ks = ks.reshape((-1,) + (1,) * niters.ndim)
    return torch.where((ks == slot) & (niters > 0), true_res, res_hist)


def _lsqr_core(iter_op, b_iter, residual_fn, error_fn, b_norm_for_estimate,
               maxit, tol, reorth=False, resume_from=None, reduce=None,
               reduce_v=None):
    """The LSQR recurrence on ``iter_op``.  ``residual_fn``: x -> true
    relative residual, or None for the cheap estimate.  Returns ``(x,
    res_hist, err_hist, niters, carry)``: the UNPATCHED histories of length
    ``maxit`` and the carry in the JAX order ``(x, u, v, w, phi_bar,
    rho_bar, alpha, active, niters, U, V)``.  ``reduce``: the sum over a
    mesh when ``iter_op`` acts on this rank's slabs of sharded vectors
    (``parallel/sharded_gkb.py``): every norm and purification pass then
    reduces over it.  ``reduce_v``: the sum for the v-space (image)
    vectors where it differs from the u-space's ``reduce`` (the 2-D mesh:
    u over "rows", v over "cols")."""
    rv = reduce if reduce_v is None else reduce_v
    dtype, device = b_iter.dtype, b_iter.device
    m, n = iter_op.shape
    k0, res_hist, err_hist = resumed_histories(resume_from, maxit, b_iter)
    Ub = Vb = None
    if resume_from is None:
        u, beta, _ = safe_normalize(b_iter, reduce)
        v, alpha, _ = safe_normalize(iter_op.rmatvec(u), rv)
        w = v
        x = torch.zeros((n,), dtype=dtype, device=device)
        phi_bar, rho_bar, alpha_c = beta, alpha, alpha
        active = torch.ones((), dtype=torch.bool, device=device)
        niters = torch.zeros((), dtype=torch.int32, device=device)
        if reorth:
            # Full reorthogonalization stores the GKB bases and
            # CGS2-purifies each new vector: O(maxit (m+n)) memory
            Ub = stored_basis(u, maxit + 1)
            Vb = stored_basis(v, maxit + 1)
    else:
        carry = resume_from.carry
        check_reorth_carry(carry, reorth, 9)
        x, u, v, w, phi_bar, rho_bar, alpha_c, active, niters = carry[:9]
        active, niters = active.to(torch.bool), niters.to(torch.int32)
        if reorth:
            Ub = stored_basis(None, maxit + 1, carry[9])
            Vb = stored_basis(None, maxit + 1, carry[10])
    nan = torch.full((), float("nan"), dtype=dtype, device=device)

    for k in range(k0, maxit):
        uhat = iter_op.matvec(v) - alpha_c * u
        if reorth:
            uhat = purify(Ub[:k + 1], uhat, reduce)
        u_n, beta_k, ok_u = safe_normalize(uhat, reduce)
        vhat = iter_op.rmatvec(u_n) - beta_k * v
        if reorth:
            vhat = purify(Vb[:k + 1], vhat, rv)
        v_n, alpha_n, ok_v = safe_normalize(vhat, rv)

        rho = torch.hypot(rho_bar, beta_k)
        c = rho_bar / rho
        s = beta_k / rho
        theta = s * alpha_n
        rho_bar_n = -c * alpha_n
        phi = c * phi_bar
        phi_bar_n = s * phi_bar

        x_n = x + (phi / rho) * w
        w_n = v_n - (theta / rho) * w

        if residual_fn is None:
            res_k = torch.abs(phi_bar_n) / b_norm_for_estimate
        else:
            res_k = residual_fn(x_n)
        err_k = error_fn(x_n)

        adopt = active & ok_u & ok_v
        x = torch.where(adopt, x_n, x)
        u = torch.where(adopt, u_n, u)
        v = torch.where(adopt, v_n, v)
        w = torch.where(adopt, w_n, w)
        if reorth:
            # only column k+1 changes: the others are what a select over
            # the whole basis would have kept
            Ub[k + 1] = torch.where(adopt, u_n, Ub[k + 1])
            Vb[k + 1] = torch.where(adopt, v_n, Vb[k + 1])
        phi_bar = torch.where(adopt, phi_bar_n, phi_bar)
        rho_bar = torch.where(adopt, rho_bar_n, rho_bar)
        alpha_c = torch.where(adopt, alpha_n, alpha_c)
        res_hist[k] = torch.where(adopt, res_k, nan)
        err_hist[k] = torch.where(adopt, err_k, nan)
        niters = torch.where(adopt, k + 1, niters)
        active = adopt & (res_k > tol)

    carry = (x, u, v, w, phi_bar, rho_bar, alpha_c, active, niters,
             None if Ub is None else Ub.T, None if Vb is None else Vb.T)
    return x, res_hist, err_hist, niters, carry


def prepare_inputs(A, b, x_true, x0, maxit):
    """The solvers' arguments as tensors on the right-hand side's device
    (numpy operators and vectors follow the rule of ``as_operator``)."""
    b = as_vector(b)
    A = as_operator(A, device=b.device)
    like = dict(dtype=b.dtype, device=b.device)
    if x_true is not None:
        x_true = torch.as_tensor(x_true, **like)
    if x0 is not None:
        x0 = torch.as_tensor(x0, **like)
    maxit = min(A.shape) if maxit is None else int(maxit)
    return A, b, x_true, x0, maxit


def lsqr(A, b, x_true=None, tol: float = 1e-6, maxit: int | None = None,
         reorth: bool = False, resume_from=None, x0=None) -> GKBResult:
    """Standard LSQR with the reference's cheap residual estimate + final
    patch.

    ``reorth=True`` fully reorthogonalizes the GKB bases (O(maxit (m+n))
    memory) — restores exact-arithmetic equivalence with AB-GMRES (B=A^T) to
    final iterations on ill-conditioned operators.

    ``resume_from``: a prior result's ``.state`` (:class:`GKBState`) — the
    recurrence continues where it stopped with the larger ``maxit`` budget,
    producing exactly the numbers of an uninterrupted run (pass the same
    ``reorth``).

    ``x0``: optional warm start — the GKB runs on the correction
    ``min ||(b - A x0) - A d||`` and returns ``x = x0 + d`` (residuals
    still reported relative to ``||b||``); pass the SAME ``x0`` when
    resuming.  Multi-RHS serving twin: ``lsqr_batched``."""
    A, b, x_true, x0, maxit = prepare_inputs(A, b, x_true, x0, maxit)
    b_norm = torch.linalg.vector_norm(b)
    b_iter = b if x0 is None else b - A.matvec(x0)
    base_err = rel_error_fn(x_true)
    error_fn = base_err if x0 is None else (lambda d: base_err(x0 + d))
    if resume_from is not None:
        check_fingerprint(resume_from, x0, None)
    # built before the loop: its host values reach the card while the queue
    # is empty, so the call returns with the solve still in flight
    fp = resume_fingerprint(x0, None, device=b.device)
    x, res_hist, err_hist, niters, carry = _lsqr_core(
        A, b_iter, None, error_fn, b_norm, maxit, tol, reorth=reorth,
        resume_from=resume_from)
    if x0 is not None:
        x = x0 + x
    state = GKBState(carry=carry, res_hist=res_hist, err_hist=err_hist,
                     fp=fp)
    true_res = torch.linalg.vector_norm(b - A.matvec(x)) / b_norm
    return GKBResult(x=x, err_hist=err_hist,
                     res_hist=patch_true_residual(res_hist, niters, true_res),
                     niters=niters, state=state)


def hybrid_lsqr(A, b, x_true=None, tol: float = 1e-6,
                maxit: int | None = None, lam: float = 1e-3, error_map=None,
                reorth: bool = False, resume_from=None, x0=None) -> GKBResult:
    """LSQR on the augmented system [A; sqrt(lam) I], residual vs original A.

    ``error_map`` (optional) maps the iterate before comparing against
    ``x_true`` — used when the iterate lives in a different space than the
    final solution (e.g. the AB-style composed solve where x = B z).
    ``resume_from``: a prior result's ``.state`` (same ``lam``/``reorth``).
    ``x0``: optional warm start — an EXACT restart of the Tikhonov problem:
    ``min_d ||A(x0+d)-b||^2 + lam ||x0+d||^2`` is the augmented LSQR on
    ``[A; sqrt(lam) I] d ~ [b - A x0; -sqrt(lam) x0]`` with ``x = x0 + d``,
    so the regularizer still acts on the full ``x``.  Pass the same ``x0``
    when resuming.  Incompatible with ``error_map`` (the offset lives in
    the iterate's own space).
    """
    A, b, x_true, x0, maxit = prepare_inputs(A, b, x_true, x0, maxit)
    if x0 is not None and error_map is not None:
        raise ValueError("x0 warm start and error_map cannot be combined")
    aug = AugmentedOperator(A, lam)
    b_norm = torch.linalg.vector_norm(b)
    if x0 is None:
        b_aug = aug.augment_rhs(b)
    else:
        sqlam = torch.sqrt(scalar_tensor(lam, b.dtype, b.device))
        b_aug = torch.cat([b - A.matvec(x0), -sqlam * x0])

    def residual_fn(d):
        x = d if x0 is None else x0 + d
        return torch.linalg.vector_norm(b - A.matvec(x)) / b_norm

    base_error_fn = rel_error_fn(x_true)
    if error_map is not None:
        def error_fn(z):
            return base_error_fn(error_map(z))
    elif x0 is not None:
        def error_fn(d):
            return base_error_fn(x0 + d)
    else:
        error_fn = base_error_fn

    if resume_from is not None:
        check_fingerprint(resume_from, x0, lam)
    fp = resume_fingerprint(x0, lam, device=b.device)
    x, res_hist, err_hist, niters, carry = _lsqr_core(
        aug, b_aug, residual_fn, error_fn, b_norm, maxit, tol,
        reorth=reorth, resume_from=resume_from)
    if x0 is not None:
        x = x0 + x
    state = GKBState(carry=carry, res_hist=res_hist, err_hist=err_hist,
                     fp=fp)
    return GKBResult(x=x, err_hist=err_hist, res_hist=res_hist,
                     niters=niters, state=state)
