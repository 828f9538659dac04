"""Solver results and the generic GMRES core (PyTorch port).

Twin of ``hybrid_gmres_tpu/solvers/common.py``.  Results keep the JAX
package's fixed-shape convention: histories have length ``maxit`` with NaN
beyond ``niters``.

The JAX ``lax.scan`` becomes a fixed-trip Python loop over preallocated
tensors.  The loop never reads a device value on the host: ``active`` and
``niters`` stay device tensors updated with ``torch.where``, so on the card
the whole solve is queued without a sync and only the caller's first read
of the result waits for it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from hybrid_gmres_tpu_torch.krylov.arnoldi import (
    arnoldi,
    arnoldi_orthogonalize,
    arnoldi_step,
    column_major,
)
from hybrid_gmres_tpu_torch.utils.checkpoint import (
    check_resumable,
    pad_state,
)
from hybrid_gmres_tpu_torch.utils.device import full_float32_matmul


class FusedResidual(NamedTuple):
    """Spec for the fused (stored-image) exact-residual mode.

    The Krylov matvec is ``w = second(first(q))`` (BA: ``B(A q)``; AB:
    ``A(B q)``).  Storing the per-step images lets the per-iteration TRUE
    residual ``||b - A x_k||`` be a small matmul against the stored image
    basis instead of an extra SpMV:

      * BA-GMRES: ``x = Q y`` so ``A x = (A Q) y``; store ``u_k = A q_k``;
      * AB-GMRES: ``x = B Q y`` so ``A x = (A B Q) y``; store ``w_k`` for the
        residual and ``s_k = B q_k`` for the solution ``x = S y``.
    """
    first_mv: Callable        # q -> first-stage image (BA: A q; AB: B q)
    second_mv: Callable       # first image -> Krylov vector w
    rhs: torch.Tensor         # image-space RHS: b, or b - A x0 when x0 != 0
    rhs_norm: torch.Tensor    # ||b|| (residual denominator, always vs b)
    img: str = "first"        # which stage's image spans A x ("first"/"second")
    solution_from_image: bool = False  # AB: x = (first images) @ y
    x_offset: Optional[torch.Tensor] = None  # x0 added to the image solution


class GMRESResult(NamedTuple):
    x: torch.Tensor          # final iterate (at iteration `niters`)
    err_hist: torch.Tensor   # (maxit,) relative error, NaN beyond niters
    res_hist: torch.Tensor   # (maxit,) relative residual
    niters: torch.Tensor     # int32: last iteration entered (1-based)
    Q: torch.Tensor          # (n_or_m, maxit+1) padded Krylov basis
    H: torch.Tensor          # (maxit+1, maxit) padded Hessenberg
    beta: torch.Tensor       # ||r0||
    IMG: Optional[torch.Tensor] = None   # (m_img, maxit), fused runs only
    S: Optional[torch.Tensor] = None     # (x_shape, maxit), AB fused only
    active: Optional[torch.Tensor] = None  # final active flag (bool)
    fp: Optional[torch.Tensor] = None    # (3,) resume fingerprint


class GKBState(NamedTuple):
    """Checkpointable GKB recurrence state (LSQR/LSMR resume).

    ``carry`` is the loop's state at the last completed iteration, in the
    JAX package's order and shapes (vectors, rotation scalars, active and
    niters, plus the stored bases when ``reorth=True``), so that a state
    saved by either package resumes in the other; the histories are the
    UNPATCHED records (LSQR's final true-residual patch is re-applied after
    a resume, so ``resume(run(maxit=k), maxit=K) == run(maxit=K)``)."""

    carry: tuple
    res_hist: torch.Tensor
    err_hist: torch.Tensor
    ar_hist: Optional[torch.Tensor] = None
    fp: Optional[torch.Tensor] = None  # (x0, lam, tag) fingerprint


class GKBResult(NamedTuple):
    x: torch.Tensor
    err_hist: torch.Tensor
    res_hist: torch.Tensor
    niters: torch.Tensor
    ar_hist: Optional[torch.Tensor] = None  # LSMR only: ||A^T r|| history
    state: Optional[GKBState] = None        # resume checkpoint (GKB family)


def gmres_core(
    krylov_mv: Callable,
    r0: torch.Tensor,
    project_solve: Callable,  # (H, Q, t, kdim) -> padded y of length maxit
    solution_fn: Callable,    # (Q, y) -> x from Q's first len(y) columns
    residual_fn: Callable,    # x -> relative residual
    error_fn: Callable,       # x -> relative error (may return NaN)
    maxit: int,
    tol: float,
    x_shape: int,
    breakdown_tol: float = 0.0,
    history: bool = True,
    resume_from: "GMRESResult | None" = None,
    x_init=None,
    residual: str = "true",
    fused: "FusedResidual | None" = None,
    defer_histories: bool = False,
    basis_dtype=None,
) -> GMRESResult:
    """Generic preconditioned GMRES loop shared by AB/BA x {non,}hybrid x
    PTR/RTP.

    Arnoldi expand -> projected solve -> residual/error tracking -> stop on
    ``res <= tol`` or breakdown (``BAgmres_hybrid_bounds.m:24-80``), as a
    fixed ``maxit``-step loop with an active mask.  With ``history=False``
    the per-iteration solves are skipped: :func:`arnoldi`, then one
    projected solve, one residual and one error, recorded in slot
    ``nsteps-1`` of NaN histories (benchmark mode).

    ``residual``: "true" recomputes ``||b - A x_k||`` with an explicit
    matvec; "estimate" uses the projected LS residual
    ``||t - Hbar y|| / beta``; "fused" computes the true residual from the
    stored per-step images (see :class:`FusedResidual`), no extra SpMV.

    ``resume_from``: a result of the same solve with a smaller (or equal)
    ``maxit``; the loop continues its factorization from step ``niters``,
    so ``resume(run(maxit=k), maxit=K)`` equals ``run(maxit=K)``.

    ``basis_dtype`` (fused only): storage dtype of ``Q``, ``IMG`` and ``S``,
    e.g. ``torch.bfloat16``; every product reads the stored columns upcast
    to the working dtype, so only the stored values are rounded.

    ``defer_histories`` (fused only): the loop runs only the Arnoldi
    expansion; the per-k projected solves are one batched solve after it and
    the histories two products (see :func:`_gmres_core_deferred`).
    """
    if residual not in ("true", "estimate", "fused"):
        raise ValueError("residual must be 'true', 'estimate' or 'fused'")
    if basis_dtype is not None and residual != "fused":
        raise ValueError("basis_dtype requires residual='fused' (the "
                         "production path; other modes hand basis columns "
                         "straight to the operator)")
    if defer_histories:
        if residual != "fused":
            raise ValueError("defer_histories requires residual='fused'")
        if resume_from is not None or not history:
            raise ValueError("defer_histories requires history=True and no "
                             "resume_from")
    if residual == "fused":
        if fused is None:
            raise ValueError("residual='fused' requires a FusedResidual spec")
        if not history:
            raise ValueError("residual='fused' requires history=True (with "
                             "history=False only one final residual is "
                             "computed; use residual='true')")
        if resume_from is not None and resume_from.IMG is None:
            raise ValueError(
                "residual='fused' resume needs a checkpoint from a fused "
                "run (resume_from.IMG is the stored image basis)")

    dtype, device = r0.dtype, r0.device
    bdt = dtype if basis_dtype is None else basis_dtype
    like = dict(dtype=dtype, device=device)
    n = r0.shape[0]
    nan = torch.full((), float("nan"), **like)

    if not history:
        if resume_from is not None:
            raise ValueError("resume_from requires history=True")
        beta = torch.linalg.vector_norm(r0)
        t = torch.zeros((maxit + 1,), **like)
        t[0] = beta
        Q, H, beta_, nsteps = arnoldi(krylov_mv, r0, maxit, breakdown_tol)
        y = project_solve(H, Q, t, nsteps)
        x = solution_fn(Q, y)
        ok = nsteps > 0
        slot = torch.clamp(nsteps - 1, min=0).long().reshape(1)
        hists = []
        for val in (residual_fn(x), error_fn(x)):
            hist = torch.full((maxit,), float("nan"), **like)
            hists.append(hist.index_copy_(
                0, slot, torch.where(ok, val, nan).reshape(1)))
        return GMRESResult(x, hists[1], hists[0], nsteps, Q, H, beta_)

    res_hist = torch.full((maxit,), float("nan"), **like)
    err_hist = torch.full((maxit,), float("nan"), **like)
    Q = column_major(n, maxit + 1, bdt, device)
    if residual == "fused":
        IMG = column_major(fused.rhs.shape[0], maxit, bdt, device)
        S = (column_major(x_shape, maxit, bdt, device)
             if fused.solution_from_image else None)
    else:
        IMG = S = None
    if resume_from is not None:
        # Continue the Arnoldi recurrence from a saved factorization
        # (utils/checkpoint.py), copied into this solve's own tensors (the
        # loop writes in place): identical numbers to an uninterrupted run.
        check_resumable(resume_from)
        rs = pad_state(resume_from, maxit)
        k0 = int(resume_from.niters)
        beta = rs.beta.to(**like)
        Q.copy_(rs.Q)
        H = rs.H.to(**like).clone()
        x = rs.x.to(**like)
        res_hist[:k0] = rs.res_hist[:k0]
        err_hist[:k0] = rs.err_hist[:k0]
        if residual == "fused":
            IMG.copy_(rs.IMG)
            if S is not None:
                if rs.S is None:
                    raise ValueError("fused resume of an image-composed (AB) "
                                     "run needs resume_from.S")
                S.copy_(rs.S)
        # A run that exhausted its budget resumes active; one that STOPPED
        # (tol or breakdown) resumes inactive.  The checkpointed flag decides;
        # legacy checkpoints fall back on niters == budget, which cannot
        # tell a stop ON the final iteration apart.
        if resume_from.active is not None:
            active = torch.as_tensor(resume_from.active, device=device).to(
                torch.bool).clone()
        else:
            active = torch.tensor(k0 == resume_from.res_hist.shape[0],
                                  device=device)
    else:
        k0 = 0
        beta = torch.linalg.vector_norm(r0)
        beta_safe = torch.where(beta > 0, beta, torch.ones((), **like))
        Q[:, 0] = torch.where(beta > 0, r0 / beta_safe, torch.zeros_like(r0))
        H = torch.zeros((maxit + 1, maxit), **like)
        x = (torch.zeros((x_shape,), **like) if x_init is None
             else torch.as_tensor(x_init, **like).clone())
        active = beta > 0
    t = torch.zeros((maxit + 1,), **like)
    t[0] = beta
    if defer_histories:
        return _gmres_core_deferred(
            fused, project_solve, solution_fn, error_fn, maxit, tol,
            x_shape, breakdown_tol, Q, H, t, beta, bdt)

    def upcast(M):
        return M if M.dtype == dtype else M.to(dtype)

    niters = torch.full((), k0, dtype=torch.int32, device=device)
    for k in range(k0, maxit):
        if residual == "fused":
            u = fused.first_mv(upcast(Q[:, k]))
            w = fused.second_mv(u)
            IMG[:, k] = u if fused.img == "first" else w
            if fused.solution_from_image:
                S[:, k] = u
            st = arnoldi_orthogonalize(Q, H, k, w, breakdown_tol, active)
        else:
            st = arnoldi_step(krylov_mv, Q, H, k, breakdown_tol, active)
        kdim = k + 1
        y = project_solve(H, Q, t, kdim)
        # the products read the kdim set columns (y is zero beyond them):
        # shapes that depend on k alone, as in arnoldi_orthogonalize
        yk = y[:kdim]
        if residual == "fused" and fused.solution_from_image:
            xk = upcast(S[:, :kdim]) @ yk
            if fused.x_offset is not None:
                xk = fused.x_offset + xk
        else:
            xk = solution_fn(Q[:, :kdim], yk)
        if residual == "true":
            res_k = residual_fn(xk)
        elif residual == "fused":
            res_k = torch.linalg.vector_norm(
                fused.rhs - upcast(IMG[:, :kdim]) @ yk) / fused.rhs_norm
        else:
            res_k = torch.linalg.vector_norm(
                t[:kdim + 1] - H[:kdim + 1, :kdim] @ yk) / beta
        err_k = error_fn(xk)
        # On (lucky) breakdown the Krylov space is invariant, so the
        # projected solve at this k is exact — adopt it, then stop (the JAX
        # package's rule, common.py:278-291).
        x = torch.where(active, xk, x)
        res_hist[k] = torch.where(active, res_k, nan)
        err_hist[k] = torch.where(active, err_k, nan)
        niters = torch.where(active, kdim, niters)
        stop = st.breakdown | (res_k <= tol)
        active = active & ~stop
    return GMRESResult(x, err_hist, res_hist, niters, Q, H, beta,
                       IMG=IMG, S=S, active=active)


def _gmres_core_deferred(fused, project_solve, solution_fn, error_fn, maxit,
                         tol, x_shape, breakdown_tol, Q, H, t, beta, bdt):
    """Deferred-histories fused GMRES: Arnoldi-only loop, then batched
    projected solves and matmul-shaped histories (see ``gmres_core``).
    ``solution_fn`` and ``error_fn`` are called once, on the (maxit, maxit)
    matrix whose column j is the padded ``y`` of step j+1.  ``bdt``: the
    storage dtype of the stored images (``basis_dtype``)."""
    dtype, device = t.dtype, t.device
    m_img = fused.rhs.shape[0]
    IMG = column_major(m_img, maxit, bdt, device)
    S = (column_major(x_shape, maxit, bdt, device)
         if fused.solution_from_image else None)
    active = beta > 0
    nsteps = torch.zeros((), dtype=torch.int32, device=device)
    broke = torch.zeros((), dtype=torch.bool, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    for k in range(maxit):
        u = fused.first_mv(Q[:, k].to(dtype))
        w = fused.second_mv(u)
        IMG[:, k] = torch.where(active, u if fused.img == "first" else w,
                                zero)
        if S is not None:
            S[:, k] = torch.where(active, u, zero)
        st = arnoldi_orthogonalize(Q, H, k, w, breakdown_tol, active)
        nsteps = nsteps + active
        broke = broke | (active & st.breakdown)
        active = active & ~st.breakdown

    ks = torch.arange(1, maxit + 1, dtype=torch.int32, device=device)
    # all maxit projected problems in one batched call: Y[j] = y_{j+1}
    Y = project_solve(H.expand(maxit, -1, -1), Q, t.expand(maxit, -1), ks)
    # full float32 whatever the caller set: the post-loop products must
    # reproduce the in-loop per-iteration matvecs
    with full_float32_matmul():
        res_full = torch.linalg.vector_norm(
            fused.rhs[:, None] - IMG.to(dtype) @ Y.T, dim=0) / fused.rhs_norm
        if fused.solution_from_image:
            X = S.to(dtype) @ Y.T
            if fused.x_offset is not None:
                X = X + fused.x_offset[:, None]
        else:
            X = solution_fn(Q, Y.T)                 # (x_shape, maxit)
    err_full = error_fn(X)

    # Post-hoc stopping: the first k with res <= tol, bounded by the
    # Arnoldi breakdown point — same niters/x/NaN-masking as the masked loop
    hit = (ks <= nsteps) & (res_full <= tol)
    any_hit = hit.any()
    first_hit = torch.argmax(hit.to(torch.int32)).to(torch.int32) + 1
    niters = torch.where(any_hit, first_hit, nsteps)
    rec = ks <= niters
    nan = torch.full((), float("nan"), dtype=dtype, device=device)
    res_hist = torch.where(rec, res_full, nan)
    err_hist = torch.where(rec, err_full, nan)
    slot = torch.clamp(niters - 1, min=0).long()
    x = torch.where(niters > 0, X.index_select(1, slot[None])[:, 0],
                    torch.zeros((x_shape,), dtype=dtype, device=device))
    # the active flag an equivalent masked loop would end with: a breakdown
    # ON the final iteration still counts in nsteps but ends inactive
    active_f = (nsteps == maxit) & ~any_hit & ~broke
    return GMRESResult(x, err_hist, res_hist, niters, Q, H, beta, IMG=IMG,
                       S=S, active=active_f)


class SplitSum(NamedTuple):
    """The sum over the ranks for a space whose local slab is two slabs
    sharded over different ranks: entries ``[:at]`` summed by ``first``,
    ``[at:]`` by ``second`` (the augmented u-space of the 2-D hybrid LSQR:
    rays over the mesh's "rows", pixels over its "cols").  Where a
    ``reduce`` is taken, this may stand in for it: :func:`inner` then
    forms and sums the two parts' products apart."""

    at: int
    first: Callable
    second: Callable


def inner(X, vec, reduce=None):
    """``X @ vec`` summed over a mesh: ``X`` (k, space) or (space,), ``vec``
    (space,) this rank's slabs; ``reduce``: None (one device), a sum of a
    local partial (e.g. ``Mesh.all_reduce``) or a :class:`SplitSum`."""
    if isinstance(reduce, SplitSum):
        a = reduce.at
        return (reduce.first(X[..., :a] @ vec[:a])
                + reduce.second(X[..., a:] @ vec[a:]))
    c = X @ vec
    return c if reduce is None else reduce(c)


def global_norm(vec, reduce=None):
    """``||vec||``; with ``reduce`` (a sum over the ranks of a mesh, e.g.
    ``Mesh.all_reduce``, or a :class:`SplitSum`) the norm of the sharded
    vector whose local slab ``vec`` is, one collective (two for a split
    space)."""
    if reduce is None:
        return torch.linalg.vector_norm(vec)
    if isinstance(reduce, SplitSum):
        return torch.sqrt(inner(vec, vec, reduce))
    return torch.sqrt(reduce(torch.dot(vec, vec)))


def safe_normalize(vec, reduce=None):
    """(vec/||vec||, ||vec||, ok): zero vectors normalize to zero, ok=False.
    All three stay on the device.  ``reduce``: as in :func:`global_norm`."""
    nrm = global_norm(vec, reduce)
    ok = nrm > 0
    safe = torch.where(ok, nrm, torch.ones_like(nrm))
    return torch.where(ok, vec / safe, torch.zeros_like(vec)), nrm, ok


def grow_stored_bases(carry, maxit, idx):
    """Pad the stored reorth bases of a resumed carry out to the new
    ``maxit + 1`` budget along axis 1 ((space, k) and batched (space, k, R)
    bases alike).  ``idx``: positions of the bases in the carry tuple.

    For callers that keep a carry in the JAX axis order; the solvers of
    this package copy a resumed basis into their own row-major layout
    instead (``lsqr.stored_basis``)."""
    carry = list(carry)
    for i in idx:
        extra = maxit + 1 - carry[i].shape[1]
        if extra > 0:
            pad = (0, 0) * (carry[i].ndim - 2) + (0, extra)
            carry[i] = torch.nn.functional.pad(carry[i], pad)
    return tuple(carry)


def rel_residual_fn(A_op, b):
    bnorm = torch.linalg.vector_norm(b)

    def f(x):
        return torch.linalg.vector_norm(b - A_op.matvec(x)) / bnorm

    return f


def rel_error_fn(x_true):
    """Relative error of an iterate (n,), or of each column of (n, j)."""
    if x_true is None:
        return lambda x: torch.full(x.shape[1:], float("nan"), dtype=x.dtype,
                                    device=x.device)
    xt_norm = torch.linalg.vector_norm(x_true)

    def f(x):
        xt = x_true if x.ndim == 1 else x_true[:, None]
        return torch.linalg.vector_norm(x - xt, dim=0) / xt_norm

    return f
