"""Batched multi-RHS GKB solvers: LSQR / hybrid LSQR / LSMR over R RHS.

Twin of ``hybrid_gmres_tpu/solvers/gkb_batched.py``, the GKB serving twins
of ``solvers/batched.py``: R INDEPENDENT bidiagonalizations in one loop,
every operator application a multi-RHS product (``op.matmat``/``rmatmat`` —
on :class:`BlockELLOperator` kernel K2 and, on forward panels only, K4: one
panel read serves the columns of a tile), every rotation recurrence
vectorized to (R,) scalars.  Per-RHS semantics match the single-RHS solvers
exactly: independent histories / niters / active flags / breakdown handling
/ warm starts / final true-residual patch (LSQR), ``reorth`` stores
(space, maxit+1, R) bases with per-RHS CGS2 purification, and
``resume_from`` continues every RHS's recurrence exactly
(fingerprint-guarded).

Hybrid LSMR has no batched form: its per-iteration stored-basis projected
solve does not amortize across RHS (use ``hybrid_lsqr_batched`` — same
Tikhonov estimator through the augmented system — or the batched hybrid
GMRES family).

Layout.  Results and the carry keep the JAX package's trailing batch axis
(``x`` (n, R), bases (space, maxit+1, R)).  Inside, every array is stored
batch-first — vectors (R, space), bases (R, maxit+1, space) — so that one
RHS's vector is contiguous, the purification products are ``torch.bmm``
over R, and the transposed views ``v.T`` go to the kernels through their
strides without a copy.  The loop writes the bases in place (own copies on
a resume; the vectors are replaced, never mutated) and never reads a device
value on the host.
"""

from __future__ import annotations

import torch

from hybrid_gmres_tpu_torch.ops.linear_operator import (
    as_operator,
    as_vector,
)
from hybrid_gmres_tpu_torch.solvers.common import GKBResult, GKBState
from hybrid_gmres_tpu_torch.solvers.lsmr import operator_fro_norm
from hybrid_gmres_tpu_torch.solvers.lsqr import (
    patch_true_residual,
    resumed_histories,
)
from hybrid_gmres_tpu_torch.utils.checkpoint import (
    check_fingerprint,
    resume_fingerprint,
)
from hybrid_gmres_tpu_torch.utils.device import scalar_tensor

__all__ = [
    "lsqr_batched",
    "hybrid_lsqr_batched",
    "lsmr_batched",
]


def _rows(a):
    """(space, R) -> batch-first (R, space), contiguous (no copy when ``a``
    is already the transposed view of such an array, as the kernels return
    it)."""
    return a.T.contiguous()


def _normalize_rows(X):
    """Per-RHS (vec/||vec||, ||vec||, ok) of the rows of ``X`` (R, space) —
    the batched ``safe_normalize``."""
    nrm = torch.linalg.vector_norm(X, dim=1)
    ok = nrm > 0
    safe = torch.where(ok, nrm, torch.ones_like(nrm))
    return torch.where(ok[:, None], X / safe[:, None],
                       torch.zeros_like(X)), nrm, ok


def _purify_rows(Basis, X):
    """Per-RHS CGS2 of ``X`` (R, space) against the stored vectors ``Basis``
    (R, k, space): two passes, each one ``bmm`` pair."""
    X = X.unsqueeze(2)
    for _ in range(2):
        X = torch.baddbmm(X, Basis.transpose(1, 2), torch.bmm(Basis, X),
                          alpha=-1)
    return X.squeeze(2)


def _stored_basis(first, ncols, prior=None):
    """Zero batch-first basis (R, ncols, space) holding ``first`` (R, space)
    in slot 0 or, on a resume, the columns of ``prior`` (space, k, R)."""
    if prior is None:
        R, space = first.shape
        out = torch.zeros((R, ncols, space), dtype=first.dtype,
                          device=first.device)
        out[:, 0] = first
    else:
        space, k, R = prior.shape
        out = torch.zeros((R, ncols, space), dtype=prior.dtype,
                          device=prior.device)
        out[:, :k] = prior.permute(2, 1, 0)
    return out


def _prep_batched(A, b, x_true, x0, maxit, name):
    b = as_vector(b)
    A = as_operator(A, device=b.device)
    if b.ndim != 2:
        raise ValueError(f"{name} expects b of shape (m, R); use the "
                         "single-RHS solver for one right-hand side")
    m, n = A.shape
    maxit = min(m, n) if maxit is None else int(maxit)
    like = dict(dtype=b.dtype, device=b.device)
    R = b.shape[1]

    def cols(a):
        """(n,) or (n, R) -> batch-first (R, n); zeros for None."""
        if a is None:
            return torch.zeros((R, n), **like)
        return torch.as_tensor(a, **like).reshape(n, -1).T.expand(
            R, n).contiguous()

    return (A, _rows(b), maxit, like, m, n, R, cols(x_true),
            x_true is not None, cols(x0), x0 is not None)


def _error_fn_rows(xt_b):
    xt_norm = torch.linalg.vector_norm(xt_b, dim=1)

    def f(Xb):
        return torch.linalg.vector_norm(Xb - xt_b, dim=1) / xt_norm

    return f


def _resume_carry(resume_from, reorth, n_plain):
    """Validate a resumed carry's reorth layout (shared by all three
    batched GKB solvers)."""
    rc = resume_from.carry
    if len(rc) != (n_plain + 2 if reorth else n_plain):
        raise ValueError("resume_from state does not match reorth=; "
                         "pass the same reorth as the original run")
    return rc


def _matmat_into(A, X, out):
    """``out[...] = A @ X`` without an intermediate where the operator can
    write through strides (``BlockELLOperator.matmat_into``: K2 writes the
    top rows of the augmented slab in place)."""
    into = getattr(A, "matmat_into", None)
    if into is None:
        out.copy_(A.matmat(X))
    else:
        into(X, out)


def _lsqr_core_batched(mm, rmm, b_iter, residual_fn, error_fn, b_norm,
                       maxit, tol, reorth, resume_from=None):
    """(R,)-batched twin of ``lsqr._lsqr_core``: same Givens recurrence per
    RHS, operator products via the injected multi-RHS ``mm``/``rmm`` on
    batch-first arrays ((R, n) -> (R, m_sp) and back).  Returns ``(x (R, n),
    res_hist, err_hist, niters, carry)``; the carry is in the JAX order and
    axis layout."""
    R = b_iter.shape[0]
    dtype, device = b_iter.dtype, b_iter.device
    k0, res_hist, err_hist = resumed_histories(resume_from, maxit, b_iter,
                                               tail=(R,))
    Ub = Vb = None
    if resume_from is None:
        u, beta, _ = _normalize_rows(b_iter)
        v, alpha, _ = _normalize_rows(rmm(u))
        w = v
        x = torch.zeros_like(v)
        phi_bar, rho_bar, alpha_c = beta, alpha, alpha
        active = beta > 0
        niters = torch.zeros((R,), dtype=torch.int32, device=device)
        if reorth:
            Ub = _stored_basis(u, maxit + 1)
            Vb = _stored_basis(v, maxit + 1)
    else:
        rc = _resume_carry(resume_from, reorth, 9)
        x, u, v, w = (_rows(a) for a in rc[:4])
        phi_bar, rho_bar, alpha_c = rc[4:7]
        active, niters = rc[7].to(torch.bool), rc[8].to(torch.int32)
        if reorth:
            Ub = _stored_basis(None, maxit + 1, rc[9])
            Vb = _stored_basis(None, maxit + 1, rc[10])
    nan = torch.full((), float("nan"), dtype=dtype, device=device)

    for k in range(k0, maxit):
        uhat = mm(v) - alpha_c[:, None] * u
        if reorth:
            uhat = _purify_rows(Ub[:, :k + 1], uhat)
        u_n, beta_k, ok_u = _normalize_rows(uhat)
        vhat = rmm(u_n) - beta_k[:, None] * v
        if reorth:
            vhat = _purify_rows(Vb[:, :k + 1], vhat)
        v_n, alpha_n, ok_v = _normalize_rows(vhat)

        rho = torch.hypot(rho_bar, beta_k)
        c = rho_bar / rho
        s = beta_k / rho
        theta = s * alpha_n
        rho_bar_n = -c * alpha_n
        phi = c * phi_bar
        phi_bar_n = s * phi_bar

        x_n = x + (phi / rho)[:, None] * w
        w_n = v_n - (theta / rho)[:, None] * w

        if residual_fn is None:
            res_k = torch.abs(phi_bar_n) / b_norm
        else:
            res_k = residual_fn(x_n)
        err_k = error_fn(x_n)

        adopt = active & ok_u & ok_v
        a = adopt[:, None]
        x = torch.where(a, x_n, x)
        u = torch.where(a, u_n, u)
        v = torch.where(a, v_n, v)
        w = torch.where(a, w_n, w)
        if reorth:
            Ub[:, k + 1] = torch.where(a, u_n, Ub[:, k + 1])
            Vb[:, k + 1] = torch.where(a, v_n, Vb[:, k + 1])
        phi_bar = torch.where(adopt, phi_bar_n, phi_bar)
        rho_bar = torch.where(adopt, rho_bar_n, rho_bar)
        alpha_c = torch.where(adopt, alpha_n, alpha_c)
        res_hist[k] = torch.where(adopt, res_k, nan)
        err_hist[k] = torch.where(adopt, err_k, nan)
        niters = torch.where(adopt, k + 1, niters)
        active = adopt & (res_k > tol)

    carry = (x.T, u.T, v.T, w.T, phi_bar, rho_bar, alpha_c, active, niters)
    if reorth:
        carry = carry + (Ub.permute(2, 1, 0), Vb.permute(2, 1, 0))
    return x, res_hist, err_hist, niters, carry


def _finish(x, res_hist, err_hist, niters, state, have_xt, ar_hist=None):
    if not have_xt:
        err_hist = torch.full_like(err_hist, float("nan"))
    return GKBResult(x=x.T, err_hist=err_hist, res_hist=res_hist,
                     niters=niters, ar_hist=ar_hist, state=state)


def lsqr_batched(A, b, x_true=None, tol: float = 0.0,
                 maxit: int | None = None, reorth: bool = False,
                 resume_from=None, x0=None) -> GKBResult:
    """Batched multi-RHS LSQR: R independent ``lsqr`` runs in one loop,
    operator products shared via multi-RHS SpMM (``lsqr_solver.m:20-47``
    semantics per RHS: cheap residual estimate, per-RHS final true-residual
    patch).  ``b``: (m, R); histories (maxit, R); ``x0``: (n, R) or (n,)
    broadcast (correction-space, ``x = x0 + d``); ``reorth``: per-RHS CGS2
    against (space, maxit+1, R) stored bases; ``resume_from``: a prior
    result's ``.state`` (same ``x0``/``reorth``; per-RHS active flags in
    the carry continue each recurrence exactly)."""
    A, bb, maxit, like, m, n, R, xt_b, have_xt, x0b, have_x0 = \
        _prep_batched(A, b, x_true, x0, maxit, "lsqr_batched")

    def mm(V):
        return _rows(A.matmat(V.T))

    def rmm(U):
        return _rows(A.rmatmat(U.T))

    b_norm = torch.linalg.vector_norm(bb, dim=1)
    b_iter = bb - mm(x0b) if have_x0 else bb
    base_err = _error_fn_rows(xt_b)
    error_fn = (lambda D: base_err(x0b + D)) if have_x0 else base_err
    x0_fp = x0b.T if have_x0 else None
    if resume_from is not None:
        check_fingerprint(resume_from, x0_fp, None)
    fp = resume_fingerprint(x0_fp, None, device=like["device"])
    x, res_hist, err_hist, niters, carry = _lsqr_core_batched(
        mm, rmm, b_iter, None, error_fn, b_norm, maxit, tol, reorth,
        resume_from=resume_from)
    if have_x0:
        x = x0b + x
    state = GKBState(carry=carry, res_hist=res_hist, err_hist=err_hist,
                     fp=fp)
    true_res = torch.linalg.vector_norm(bb - mm(x), dim=1) / b_norm
    return _finish(x, patch_true_residual(res_hist, niters, true_res),
                   err_hist, niters, state, have_xt)


def hybrid_lsqr_batched(A, b, x_true=None, tol: float = 0.0,
                        maxit: int | None = None, lam=1e-3,
                        reorth: bool = False, resume_from=None,
                        x0=None) -> GKBResult:
    """Batched multi-RHS hybrid LSQR: per RHS, LSQR on the Tikhonov-
    augmented ``[A; sqrt(lam) I]`` with the residual tracked vs the
    unaugmented system (``hybrid_lsqr_solver.m:5-6,43``).  ``x0``: the
    EXACT per-RHS Tikhonov restart (augmented rhs
    ``[b - A x0; -sqrt(lam) x0]``, ``x = x0 + d``).  The augmented u-basis
    is carried as one (m+n, R) slab: the operator's product is written into
    its top rows and read back from them in place.

    ``lam``: scalar, or an (R,)-vector of PER-RHS regularization weights
    (the sqrt(lam) block broadcasts along the right-hand sides); the resume
    fingerprint encodes the full vector."""
    A, bb, maxit, like, m, n, R, xt_b, have_xt, x0b, have_x0 = \
        _prep_batched(A, b, x_true, x0, maxit, "hybrid_lsqr_batched")
    lam_arr = scalar_tensor(lam, **like)
    if lam_arr.ndim not in (0, 1) or \
            (lam_arr.ndim == 1 and lam_arr.shape[0] != R):
        raise ValueError(f"lam must be a scalar or an (R,)={R} vector")
    sql = torch.sqrt(lam_arr).reshape(-1, 1)        # (1, 1) or (R, 1)
    b_norm = torch.linalg.vector_norm(bb, dim=1)

    def mm(V):
        out = torch.empty((R, m + n), **like)
        _matmat_into(A, V.T, out[:, :m].T)
        out[:, m:] = sql * V
        return out

    def rmm(U):
        return _rows(A.rmatmat(U[:, :m].T)) + sql * U[:, m:]

    def a_rows(X):
        return _rows(A.matmat(X.T))

    b_aug = torch.zeros((R, m + n), **like)
    if have_x0:
        b_aug[:, :m] = bb - a_rows(x0b)
        b_aug[:, m:] = -sql * x0b
    else:
        b_aug[:, :m] = bb

    def residual_fn(D):
        return torch.linalg.vector_norm(bb - a_rows(x0b + D), dim=1) / b_norm

    base_err = _error_fn_rows(xt_b)
    x0_fp = x0b.T if have_x0 else None
    if resume_from is not None:
        check_fingerprint(resume_from, x0_fp, lam)
    fp = resume_fingerprint(x0_fp, lam, device=like["device"])
    d, res_hist, err_hist, niters, carry = _lsqr_core_batched(
        mm, rmm, b_aug, residual_fn, lambda D: base_err(x0b + D), b_norm,
        maxit, tol, reorth, resume_from=resume_from)
    state = GKBState(carry=carry, res_hist=res_hist, err_hist=err_hist,
                     fp=fp)
    return _finish(x0b + d, res_hist, err_hist, niters, state, have_xt)


def lsmr_batched(A, b, x_true=None, tol: float = 0.0,
                 maxit: int | None = None, fro_norm=None,
                 reorth: bool = False, resume_from=None,
                 x0=None) -> GKBResult:
    """Batched multi-RHS LSMR (``lsmr_solver.m:32-77`` per RHS): GKB +
    double plane rotations vectorized to (R,), TRUE residual / error /
    ``||A^T r||`` histories per RHS (``ar_hist`` (maxit, R); exact when the
    operator records ``fro_norm``).  Each step applies ``A`` and ``A^T``
    twice."""
    A, bb, maxit, like, m, n, R, xt_b, have_xt, x0b, have_x0 = \
        _prep_batched(A, b, x_true, x0, maxit, "lsmr_batched")
    device = like["device"]
    eps = torch.finfo(like["dtype"]).eps
    b_norm = torch.linalg.vector_norm(bb, dim=1)
    fro_norm = operator_fro_norm(A, fro_norm, bb)
    error_fn = _error_fn_rows(xt_b)
    x0_fp = x0b.T if have_x0 else None
    fp = resume_fingerprint(x0_fp, None, device=device)   # before the loop

    def mm(V):
        return _rows(A.matmat(V.T))

    def rmm(U):
        return _rows(A.rmatmat(U.T))

    k0, res_hist, err_hist = resumed_histories(resume_from, maxit, bb,
                                               tail=(R,))
    ar_hist = torch.full((maxit, R), float("nan"), **like)
    Ub = Vb = None
    if resume_from is None:
        b_iter = bb - mm(x0b) if have_x0 else bb
        u, beta1, _ = _normalize_rows(b_iter)
        v, alpha1, _ = _normalize_rows(rmm(u))
        x, h, hbar = x0b, v, torch.zeros_like(v)
        one = torch.ones((R,), **like)
        alpha, zetabar, alphabar = alpha1, alpha1 * beta1, alpha1
        rho, rhobar, cbar, sbar = one, one, one, torch.zeros((R,), **like)
        active = beta1 > 0
        niters = torch.zeros((R,), dtype=torch.int32, device=device)
        if reorth:
            Ub = _stored_basis(u, maxit + 1)
            Vb = _stored_basis(v, maxit + 1)
    else:
        check_fingerprint(resume_from, x0_fp, None)
        rc = _resume_carry(resume_from, reorth, 14)
        x, u, v, h, hbar = (_rows(a) for a in rc[:5])
        alpha, zetabar, alphabar, rho, rhobar, cbar, sbar = rc[5:12]
        active, niters = rc[12].to(torch.bool), rc[13].to(torch.int32)
        ar_hist[:k0] = resume_from.ar_hist
        if reorth:
            Ub = _stored_basis(None, maxit + 1, rc[14])
            Vb = _stored_basis(None, maxit + 1, rc[15])
    nan = torch.full((), float("nan"), **like)

    for k in range(k0, maxit):
        uhat = mm(v) - alpha[:, None] * u
        if reorth:
            uhat = _purify_rows(Ub[:, :k + 1], uhat)
        u_n, beta_k, ok_u = _normalize_rows(uhat)
        vhat = rmm(u_n) - beta_k[:, None] * v
        if reorth:
            vhat = _purify_rows(Vb[:, :k + 1], vhat)
        v_n, alpha_n, ok_v = _normalize_rows(vhat)

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

        hbar_n = h - ((thetabar * rho_n) / (rhoold * rhobarold))[:, None] \
            * hbar
        x_n = x + (zeta / (rho_n * rhobar_n))[:, None] * hbar_n
        h_n = v_n - (thetanew / rho_n)[:, None] * h

        Rres = bb - mm(x_n)
        r_norm = torch.linalg.vector_norm(Rres, dim=1)
        res_k = r_norm / (b_norm + eps)
        ar_k = torch.linalg.vector_norm(rmm(Rres), dim=1) / (
            fro_norm * torch.clamp(r_norm, min=eps))
        err_k = error_fn(x_n)

        adopt = active & ok_u & ok_v
        a = adopt[:, None]
        x = torch.where(a, x_n, x)
        u = torch.where(a, u_n, u)
        v = torch.where(a, v_n, v)
        h = torch.where(a, h_n, h)
        hbar = torch.where(a, hbar_n, hbar)
        if reorth:
            Ub[:, k + 1] = torch.where(a, u_n, Ub[:, k + 1])
            Vb[:, k + 1] = torch.where(a, v_n, Vb[:, k + 1])
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

    carry = (x.T, u.T, v.T, h.T, hbar.T, alpha, zetabar, alphabar, rho,
             rhobar, cbar, sbar, active, niters)
    if reorth:
        carry = carry + (Ub.permute(2, 1, 0), Vb.permute(2, 1, 0))
    state = GKBState(carry=carry, res_hist=res_hist, err_hist=err_hist,
                     ar_hist=ar_hist, fp=fp)
    return _finish(x, res_hist, err_hist, niters, state, have_xt,
                   ar_hist=ar_hist)
