"""Batched (multi-RHS) hybrid BA/AB-GMRES — the serving path (PyTorch port).

Twin of ``hybrid_gmres_tpu/solvers/batched.py``.  Reconstructs R sinograms
in ONE solve: every Krylov product is a multi-RHS SpMM
(``LinearOperator.matmat`` — for :class:`BlockELLOperator` one panel read
serves the columns), while the per-RHS Arnoldi recurrences, projected solves
and histories stay independent (each RHS has its own Krylov space and its
own Hessenberg — this is NOT block GMRES).  Semantics per RHS match
``ba_gmres``/``ab_gmres`` with ``residual="fused"``, including warm starts
(``x0``) and checkpoint/resume (``resume_from``).

R is split into scans of at most ``chunk_rhs`` (default 8, the JAX
package's default) right-hand sides that share nothing but the operators.

Layout.  Results keep the JAX package's trailing batch axis (``x`` (n, R),
``Q`` (nsp, maxit+1, R), ...).  Inside, every array is stored batch-first
with the space axis last — ``Qb`` (R, maxit+1, nsp), ``IMGb`` (R, maxit, m)
— so that a basis column of one RHS is contiguous, the CGS2 and history
products are ``torch.bmm`` over R, and the block of columns ``Qb[:, k].T``
goes to the SpMM kernel as a strided view without a copy.  The results are
views of those arrays in the JAX axis order.  As in the single-RHS port the
loop writes in place and never reads a device value on the host.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from hybrid_gmres_tpu_torch.krylov.projected import projected_tikhonov_solve
from hybrid_gmres_tpu_torch.ops.linear_operator import (
    as_operator,
    as_vector,
)
from hybrid_gmres_tpu_torch.solvers.common import GMRESResult
from hybrid_gmres_tpu_torch.solvers.gmres import _make_project_solve
from hybrid_gmres_tpu_torch.utils.checkpoint import (
    check_fingerprint,
    resume_fingerprint,
)
from hybrid_gmres_tpu_torch.utils.device import full_float32_matmul


def _make_select_lam(trace_dim, gcv_grid):
    """Per-RHS ONE-SHOT GCV selector (``lam="gcv-final"``): pick, for each
    RHS, the lambda minimizing the GCV functional of its FINAL projected
    problem — 2 SVDs per RHS in total, against 2 per (k, RHS) for the
    per-iteration ``lam="gcv"``.  The per-k solves then run at that fixed
    per-RHS lambda."""
    from hybrid_gmres_tpu_torch.reg.gcv import gcv_grid_lambda

    def select(Hb, tb, nsteps):
        grid = torch.as_tensor(
            np.logspace(-8, -1, 50) if gcv_grid is None else gcv_grid,
            dtype=Hb.dtype, device=Hb.device)
        return gcv_grid_lambda(Hb, tb, nsteps, grid, trace_dim)

    return select


def _pad_batched(res: GMRESResult, maxit: int):
    """Pad a batched checkpoint's maxit axes out to a larger budget."""
    maxit1 = res.res_hist.shape[0]
    if maxit1 > maxit:
        raise ValueError(f"resume needs maxit >= checkpointed {maxit1}")
    pk = maxit - maxit1
    pad = torch.nn.functional.pad

    def pad_cols(a):            # axis 1 of (space, k, R)
        return None if a is None else pad(a, (0, 0, 0, pk))

    return res._replace(
        Q=pad_cols(res.Q),                     # (nsp, maxit+1, R)
        H=pad(res.H, (0, 0, 0, pk, 0, pk)),    # (maxit+1, maxit, R)
        IMG=pad_cols(res.IMG),                 # (m_img, maxit, R)
        S=pad_cols(res.S),                     # (nx, maxit, R)
    )


def _column_norms(X):
    """Norms along the last (space) axis of a batch-first array."""
    return torch.linalg.vector_norm(X, dim=-1)


class Reductions(NamedTuple):
    """The sums over the space axis that the batched cores make, as
    functions: ``coeff`` the CGS2 coefficients (R, k+1, 1) of one pass,
    ``norm_m``/``norm_sp``/``norm_n`` the norms along the last axis of
    batch-first arrays in the image (m) space, the Krylov basis space and
    the solution (n) space.  :data:`LOCAL` for one device; the sharded
    solvers (``parallel/sharded_batched.py``) inject the sums over their
    mesh, one collective each."""

    coeff: Callable
    norm_m: Callable
    norm_sp: Callable
    norm_n: Callable


LOCAL = Reductions(coeff=lambda c: c, norm_m=_column_norms,
                   norm_sp=_column_norms, norm_n=_column_norms)


def _rows(a):
    """(space, R) -> a contiguous batch-first (R, space) copy."""
    return a.T.contiguous()


def _own(a, *perm):
    """A batch-first contiguous copy of a result array in the JAX axis
    order: the loop writes in place and must not write into the caller's
    checkpoint."""
    return a.permute(*perm).clone(memory_format=torch.contiguous_format)


def _batched_cgs2(Qb, Hb, Wb, k, active, red=LOCAL):
    """Two-pass CGS2 + breakdown-masked adoption, shared by the in-scan and
    deferred batched cores (the deferred == in-scan parity contract).

    ``Qb`` (R, maxit+1, nsp) and ``Hb`` (R, maxit+1, maxit) are written in
    place, only where ``active``: frozen RHS keep their columns.  The
    products run against the k+1 columns set so far (the padded columns
    beyond them are zero).  Returns the per-RHS breakdown flags.  ``red``:
    the sums over the basis space (:class:`Reductions`)."""
    dtype, device = Wb.dtype, Wb.device
    Qk = Qb[:, :k + 1]                                   # (R, k+1, nsp)
    W = Wb.unsqueeze(2)                                  # (R, nsp, 1)
    c1 = red.coeff(torch.bmm(Qk, W))                     # (R, k+1, 1)
    W = torch.baddbmm(W, Qk.transpose(1, 2), c1, alpha=-1)
    c2 = red.coeff(torch.bmm(Qk, W))
    W = torch.baddbmm(W, Qk.transpose(1, 2), c2, alpha=-1).squeeze(2)
    h = (c1 + c2).squeeze(2)                             # (R, k+1)
    hnorm = red.norm_sp(W)                               # (R,)
    breakdown = hnorm <= 0
    hsafe = torch.where(breakdown, torch.ones((), dtype=dtype, device=device),
                        hnorm)
    qnew = torch.where(breakdown[:, None], torch.zeros_like(W),
                       W / hsafe[:, None])
    a = active[:, None]
    Hb[:, :k + 1, k] = torch.where(a, h, Hb[:, :k + 1, k])
    Hb[:, k + 1, k] = torch.where(active, hnorm, Hb[:, k + 1, k])
    Qb[:, k + 1] = torch.where(a, qnew, Qb[:, k + 1])
    return breakdown


def _start(r0, maxit, dtype, device, red=LOCAL):
    """beta, t and the zero-padded bases of a cold start (batch-first)."""
    r0b = _rows(r0)
    R, nsp = r0b.shape
    beta = red.norm_sp(r0b)                              # (R,)
    beta_safe = torch.where(beta > 0, beta,
                            torch.ones((), dtype=dtype, device=device))
    Qb = torch.zeros((R, maxit + 1, nsp), dtype=dtype, device=device)
    Qb[:, 0] = torch.where((beta > 0)[:, None], r0b / beta_safe[:, None],
                           torch.zeros_like(r0b))
    Hb = torch.zeros((R, maxit + 1, maxit), dtype=dtype, device=device)
    return beta, Qb, Hb


def _result(x, err_hist, res_hist, niters, Qb, Hb, beta, IMGb, Sb, active):
    """Batch-first arrays -> a GMRESResult of views in the JAX axis order."""
    return GMRESResult(
        x.T, err_hist, res_hist, niters, Qb.permute(2, 1, 0),
        Hb.permute(1, 2, 0), beta, IMG=IMGb.permute(2, 1, 0),
        S=None if Sb is None else Sb.permute(2, 1, 0), active=active)


def _batched_core(first_mm, second_mm, r0, rhs, b_norm, project_solve,
                  solution, x_true, maxit, tol, img_stage,
                  x_offset=None, resume=None, red=LOCAL):
    """Shared loop: per-RHS CGS2 Arnoldi with multi-RHS operator products.

    ``first_mm``/``second_mm``: the two stages of the composed Krylov
    product (BA: A then B; AB: B then A), acting on (space, R) matrices.
    ``r0`` (space, R) starting residuals (``None`` when resuming — the
    carried state supplies shapes and beta); ``rhs`` (m_img, R) the fused
    residual target (``b - A x0`` under a warm start); ``img_stage``: which
    stage's image spans ``A x``.  ``solution``: "basis" (x = x0 + Q y, BA)
    or "image" (x = x0 + S y, AB).  ``x_offset``: (nx, R) warm-start
    iterate or None.  ``resume``: a prior batched :class:`GMRESResult`
    already padded to ``maxit`` — the loop continues at its history length
    with the carried per-RHS active flags (frozen RHS stay frozen).
    ``red``: the sums over the space axes (:class:`Reductions`; the
    sharded solvers run this loop on their slabs with the mesh's).
    """
    dtype, device = rhs.dtype, rhs.device
    like = dict(dtype=dtype, device=device)
    rhs_b, xt_b = _rows(rhs), _rows(x_true)
    m_img, nx = rhs_b.shape[1], xt_b.shape[1]
    x_off_b = None if x_offset is None else _rows(x_offset)

    if resume is None:
        k0 = 0
        beta, Qb, Hb = _start(r0, maxit, dtype, device, red)
        R = Qb.shape[0]
        IMGb = torch.zeros((R, maxit, m_img), **like)
        Sb = (torch.zeros((R, maxit, nx), **like)
              if solution == "image" else None)
        x = (torch.zeros((R, nx), **like) if x_off_b is None
             else x_off_b.clone())
        active = beta > 0
        niters = torch.zeros((R,), dtype=torch.int32, device=device)
    else:
        if resume.active is None:
            raise ValueError("batched resume needs the checkpointed "
                             "per-RHS active flags (result.active)")
        k0 = resume.res_hist.shape[0]   # the prior run's maxit
        beta = resume.beta
        Qb, Hb = _own(resume.Q, 2, 1, 0), _own(resume.H, 2, 0, 1)
        IMGb = _own(resume.IMG, 2, 1, 0)
        Sb = _own(resume.S, 2, 1, 0) if solution == "image" else None
        R = Qb.shape[0]
        x = _own(resume.x, 1, 0)
        active = resume.active.to(torch.bool)
        niters = resume.niters.to(torch.int32)
    tb = torch.zeros((R, maxit + 1), **like)
    tb[:, 0] = beta
    xt_norm = red.norm_n(xt_b)                           # (R,)
    nan = torch.full((), float("nan"), **like)
    res_hist = torch.full((maxit, R), float("nan"), **like)
    err_hist = torch.full((maxit, R), float("nan"), **like)
    if resume is not None:
        res_hist[:k0] = resume.res_hist
        err_hist[:k0] = resume.err_hist
    basis = Sb if solution == "image" else Qb

    for k in range(k0, maxit):
        Ub = first_mm(Qb[:, k].T).T                      # (R, mid)
        Wb = second_mm(Ub.T).T                           # (R, nsp)
        IMGb[:, k] = Ub if img_stage == "first" else Wb
        if Sb is not None:
            Sb[:, k] = Ub
        breakdown = _batched_cgs2(Qb, Hb, Wb, k, active, red)

        kdim = k + 1
        y = project_solve(Hb, tb, kdim)                  # (R, maxit)
        yk = y[:, None, :kdim]     # zero beyond kdim: the set columns do
        xk = torch.bmm(yk, basis[:, :kdim]).squeeze(1)   # (R, nx)
        if x_off_b is not None:
            xk = x_off_b + xk
        res = red.norm_m(
            rhs_b - torch.bmm(yk, IMGb[:, :kdim]).squeeze(1)) / b_norm
        err = red.norm_n(xk - xt_b) / xt_norm

        x = torch.where(active[:, None], xk, x)
        res_hist[k] = torch.where(active, res, nan)
        err_hist[k] = torch.where(active, err, nan)
        niters = torch.where(active, kdim, niters)
        active = active & ~(breakdown | (res <= tol))
    return _result(x, err_hist, res_hist, niters, Qb, Hb, beta, IMGb, Sb,
                   active)


def _batched_core_deferred(first_mm, second_mm, r0, rhs, b_norm,
                           project_solve, solution, x_true, maxit, tol,
                           img_stage, x_offset=None, select_lam=None,
                           red=LOCAL):
    """Deferred-histories batched loop (the multi-RHS twin of
    ``_gmres_core_deferred``): the loop runs ONLY the Arnoldi expansion
    (SpMM + CGS2 + image stacking); the per-(k, RHS) projected solves become
    one batched post-loop solve, and the residual/error histories two big
    batched products.  Early exit of the ITERATION is traded away exactly
    as in the single-RHS mode (``tol`` honored post hoc) — right for
    fixed-budget serving solves.  No resume support.  ``red`` as in
    :func:`_batched_core`.
    """
    dtype, device = rhs.dtype, rhs.device
    like = dict(dtype=dtype, device=device)
    rhs_b, xt_b = _rows(rhs), _rows(x_true)
    m_img, nx = rhs_b.shape[1], xt_b.shape[1]
    x_off_b = None if x_offset is None else _rows(x_offset)
    beta, Qb, Hb = _start(r0, maxit, dtype, device, red)
    R = Qb.shape[0]
    tb = torch.zeros((R, maxit + 1), **like)
    tb[:, 0] = beta
    IMGb = torch.zeros((R, maxit, m_img), **like)
    Sb = torch.zeros((R, maxit, nx), **like) if solution == "image" else None
    xt_norm = red.norm_n(xt_b)
    zero = torch.zeros((), **like)
    active = beta > 0
    nsteps = torch.zeros((R,), dtype=torch.int32, device=device)
    broke = torch.zeros((R,), dtype=torch.bool, device=device)

    for k in range(maxit):
        Ub = first_mm(Qb[:, k].T).T
        Wb = second_mm(Ub.T).T
        a = active[:, None]
        IMGb[:, k] = torch.where(a, Ub if img_stage == "first" else Wb, zero)
        if Sb is not None:
            Sb[:, k] = torch.where(a, Ub, zero)
        breakdown = _batched_cgs2(Qb, Hb, Wb, k, active, red)
        nsteps = nsteps + active
        broke = broke | (active & breakdown)
        active = active & ~breakdown

    ks = torch.arange(1, maxit + 1, dtype=torch.int32, device=device)
    Hk = Hb.expand(maxit, -1, -1, -1)     # every k sees the same H and t
    tk = tb.expand(maxit, -1, -1)
    if select_lam is not None:
        # gcv-final: ONE GCV selection per RHS (from its final projected
        # problem), then fixed-lambda Tikhonov solves for every k
        lam_r = select_lam(Hb, tb, nsteps)               # (R,)
        Y = projected_tikhonov_solve(Hk, tk, lam_r, ks[:, None])
    else:
        Y = project_solve(Hk, tk, ks[:, None])           # (k, R, maxit)
    Yb = Y.permute(1, 0, 2)                              # (R, k, maxit)

    # full float32 whatever the caller set: the one-time post-loop products
    # must reproduce the in-loop per-iteration ones
    with full_float32_matmul():
        RES = rhs_b[:, None, :] - torch.bmm(Yb, IMGb)    # (R, k, m_img)
        res_full = (red.norm_m(RES) / b_norm[:, None]).T
        del RES
        basis = Sb if solution == "image" else Qb[:, :maxit]
        X = torch.bmm(Yb, basis)                         # (R, k, nx)
    if x_off_b is not None:
        X = X + x_off_b[:, None, :]
    err_full = (red.norm_n(X - xt_b[:, None, :])
                / xt_norm[:, None]).T                    # (maxit, R)

    hit = (ks[:, None] <= nsteps[None, :]) & (res_full <= tol)
    any_hit = hit.any(dim=0)
    first_hit = torch.argmax(hit.to(torch.int32), dim=0).to(torch.int32) + 1
    niters = torch.where(any_hit, first_hit, nsteps)     # (R,)
    rec = ks[:, None] <= niters[None, :]
    nan = torch.full((), float("nan"), **like)
    res_hist = torch.where(rec, res_full, nan)
    err_hist = torch.where(rec, err_full, nan)
    slot = torch.clamp(niters - 1, min=0).long()
    # niters == 0 falls back to the warm-start iterate (an exactly
    # converged RHS must return x0, as the in-scan core does), not zero
    x_fall = torch.zeros((R, nx), **like) if x_off_b is None else x_off_b
    x = torch.where((niters > 0)[:, None],
                    X[torch.arange(R, device=device), slot], x_fall)
    # a breakdown on the FINAL iteration still counts in nsteps but the
    # equivalent in-scan run ends inactive — exclude it, or a resumed solve
    # would iterate on the zero Krylov vector
    active_f = (nsteps == maxit) & ~any_hit & ~broke
    return _result(x, err_hist, res_hist, niters, Qb, Hb, beta, IMGb, Sb,
                   active_f)


def _chunk_slices(R, chunk_rhs):
    if chunk_rhs is None or chunk_rhs >= R:
        return [slice(None)]
    c = int(chunk_rhs)
    if c < 1:
        raise ValueError("chunk_rhs must be >= 1")
    return [slice(i, min(i + c, R)) for i in range(0, R, c)]


# the axis of each result field that carries the batch
_BATCH_AXIS = dict(x=1, err_hist=1, res_hist=1, niters=0, Q=2, H=2, beta=0,
                   IMG=2, S=2, active=0)


def _concat_results(parts):
    if len(parts) == 1:
        return parts[0]
    return GMRESResult(**{
        name: None if getattr(parts[0], name) is None else torch.cat(
            [getattr(p, name) for p in parts], dim=axis)
        for name, axis in _BATCH_AXIS.items()})


def _slice_result(res: GMRESResult, sl):
    return GMRESResult(**{
        name: None if getattr(res, name) is None else
        getattr(res, name)[(slice(None),) * axis + (sl,)]
        for name, axis in _BATCH_AXIS.items()})


def _prepare_resume(kind, resume_from, x0, lam, maxit, defer_histories):
    """A batched checkpoint checked against this solve (fingerprint of
    ``x0``/``lam``, in-loop mode, stored images) and padded to ``maxit``;
    None stays None."""
    if resume_from is None:
        return None
    check_fingerprint(resume_from, x0, lam)
    if defer_histories:
        raise ValueError("defer_histories does not support resume_from")
    if resume_from.IMG is None or (kind == "ab" and resume_from.S is None):
        raise ValueError("resume_from must come from the batched "
                         "fused solver (missing .IMG/.S)")
    return _pad_batched(resume_from, maxit)


def _lam_solvers(lam, trace_dim, gcv_grid, defer_histories):
    """``(project_solve, select_lam)`` of a batched solve: the per-RHS
    projected solve ``(Hb, tb, kdim) -> y`` of ``lam`` (None for
    ``"gcv-final"``), and the one-shot selector of ``"gcv-final"`` (else
    None)."""
    if isinstance(lam, str) and lam == "gcv-final":
        if not defer_histories:
            raise ValueError(
                "lam='gcv-final' requires defer_histories=True — it "
                "selects lambda once per RHS from the final projected "
                "problem, which only exists post-scan (the serving mode); "
                "use lam='gcv' for per-iteration adaptive selection")
        return None, _make_select_lam(trace_dim, gcv_grid)
    _ps = _make_project_solve(lam, trace_dim, gcv_grid)

    def project_solve(H, t, kdim):
        return _ps(H, None, t, kdim)

    return project_solve, None


def _batched_solver(kind, A, B, b, x_true, tol, maxit, lam, gcv_grid,
                    x0, resume_from, chunk_rhs, defer_histories=False):
    b = as_vector(b)
    A = as_operator(A, device=b.device)
    B = as_operator(B, device=b.device)
    if b.ndim != 2:
        raise ValueError(f"{kind}_gmres_batched expects b of shape (m, R); "
                         f"use {kind}_gmres for a single RHS")
    maxit = min(A.shape) if maxit is None else int(maxit)
    m, n = A.shape
    R = b.shape[1]
    like = dict(dtype=b.dtype, device=b.device)
    if x_true is None:
        xt = torch.full((n, R), float("nan"), **like)
    else:
        xt = torch.as_tensor(x_true, **like).reshape(n, -1).expand(n, R)
    if x0 is not None:
        x0 = torch.as_tensor(x0, **like).reshape(n, -1).expand(n, R)

    resume_from = _prepare_resume(kind, resume_from, x0, lam, maxit,
                                  defer_histories)
    project_solve, select_lam = _lam_solvers(
        lam, n if kind == "ba" else m, gcv_grid, defer_histories)
    b_norm = torch.linalg.vector_norm(b, dim=0)

    parts = []
    for sl in _chunk_slices(R, chunk_rhs):
        b_c = b[:, sl]
        x0_c = None if x0 is None else x0[:, sl]
        rs_c = None if resume_from is None else _slice_result(resume_from,
                                                              sl)
        rhs_c = b_c if x0_c is None else b_c - A.matmat(x0_c)
        core = _batched_core_deferred if defer_histories else _batched_core
        extra = ({"select_lam": select_lam} if defer_histories
                 else {"resume": rs_c})
        if kind == "ba":
            # r0 only seeds a COLD start; on resume the SpMM would be dead
            r0_c = None if rs_c is not None else B.matmat(rhs_c)
            first_mm, second_mm = A.matmat, B.matmat
            solution, img_stage = "basis", "first"
        else:
            r0_c = rhs_c
            first_mm, second_mm = B.matmat, A.matmat
            solution, img_stage = "image", "second"
        parts.append(core(
            first_mm=first_mm, second_mm=second_mm, r0=r0_c, rhs=rhs_c,
            b_norm=b_norm[sl], project_solve=project_solve,
            solution=solution, x_true=xt[:, sl], maxit=maxit, tol=tol,
            img_stage=img_stage, x_offset=x0_c, **extra))
    res = _concat_results(parts)
    if x_true is None:
        res = res._replace(err_hist=torch.full_like(res.err_hist,
                                                    float("nan")))
    return res._replace(fp=resume_fingerprint(x0, lam, device=b.device))


def ba_gmres_batched(
    A,
    B,
    b,
    x_true=None,
    tol: float = 0.0,
    maxit: int | None = None,
    lam=None,
    gcv_grid=None,
    x0=None,
    resume_from: GMRESResult | None = None,
    chunk_rhs: int | None = 8,
    defer_histories: bool = False,
) -> GMRESResult:
    """Batched (hybrid) BA-GMRES over R right-hand sides.

    ``b``: (m, R).  ``x_true``: optional (n, R) (or (n,) broadcast).
    Returns a :class:`GMRESResult` with a trailing batch axis: ``x`` (n,
    R), histories (maxit, R), ``niters`` (R,), ``Q`` (n, maxit+1, R), ``H``
    (maxit+1, maxit, R), ``IMG`` (m, maxit, R), ``beta``/``active`` (R,).
    ``lam``: None / scalar / "gcv" (adaptive per RHS and per iteration: two
    SVDs per (k, RHS)) / "gcv-final" (adaptive per RHS, selected ONCE from
    the final projected problem; requires ``defer_histories=True``).

    ``x0``: optional (n, R) (or (n,) broadcast) warm start — per RHS
    ``r0 = B (b - A x0)``, ``x = x0 + Q y``, matching single-RHS
    ``ba_gmres(x0=...)``; the serving move is passing frame t-1's solution
    as frame t's ``x0``.  ``resume_from``: a prior result of THIS solver —
    continues every RHS's Arnoldi recurrence exactly (pass the same
    ``x0``/``lam``/``chunk_rhs``).  ``chunk_rhs``: R is split into scans of
    at most this many RHS (None disables chunking).  ``defer_histories``:
    Arnoldi-only loop + batched post-loop solves/histories (same numbers;
    trades in-iteration early exit for one pass over the image basis)."""
    return _batched_solver("ba", A, B, b, x_true, tol, maxit, lam, gcv_grid,
                           x0, resume_from, chunk_rhs, defer_histories)


def ab_gmres_batched(
    A,
    B,
    b,
    x_true=None,
    tol: float = 0.0,
    maxit: int | None = None,
    lam=None,
    gcv_grid=None,
    x0=None,
    resume_from: GMRESResult | None = None,
    chunk_rhs: int | None = 8,
    defer_histories: bool = False,
) -> GMRESResult:
    """Batched (hybrid) AB-GMRES over R right-hand sides (m-space Krylov
    bases, solution composed from the stored ``B q_k`` images; per-RHS
    ``r0 = b - A x0``, ``x = x0 + S y``).  See :func:`ba_gmres_batched`
    for ``x0``/``resume_from``/``chunk_rhs``/``defer_histories``."""
    return _batched_solver("ab", A, B, b, x_true, tol, maxit, lam, gcv_grid,
                           x0, resume_from, chunk_rhs, defer_histories)
