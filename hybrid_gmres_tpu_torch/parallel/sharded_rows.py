"""Sharded (hybrid) BA/AB-GMRES on per-shard row-packed forms (PyTorch port
of ``hybrid_gmres_tpu/parallel/sharded_pallas.py``; the functions keep its
names).

Local compute is the single-chip production kernels on each rank's shard of
``parallel/panels.py``: the redesigned K1 (``row_matvec``) on the forward
form and the redesigned K3 (``row_rmatvec``) on the form of its transpose,
both in ``csrc/row_spmv.cu``.  The per-iteration schedule is the JAX one:

  * one x gather for A's rows: windowed shifts when the panel's static
    column support allows (``L * n/p`` values), else one all_gather;
  * the back-projector B, in one of two layouts:
      - transposed (``BT_panels``, the default): K3 on this rank's rows of
        B^T gives a window-relative n-space partial, and one
        reduce_scatter lands it on the n-sharded basis;
      - forward (``B_panels``): K1 on this rank's pixel rows of B after a
        gather of the m-sharded intermediate through B's own window, and
        no reduction;
  * one fused all_reduce of the k+1 CGS2 coefficients per pass; the norm
    of the new column; the residual and error terms in one all_reduce; the
    TRUE residual from the stored images ``A q_k`` (no extra product).

SPMD, one process per card: every rank calls the solver with the
host-built panels or its own :func:`~panels.shard_view`, the full ``b``
and ``x_true`` (and ``x0``), and slices its own rows.  A solver puts the
rank's shard on the mesh's device at every call, where host-built panels
copy it there; a view already on that device
(``shard_view(panels, mesh.index, mesh.device)``, made once) is used as it
is, and the restarted wrappers make that view once for all their cycles.  The result holds the
replicated ``x`` and histories and this rank's slabs of the bases (``Q``,
``IMG``, ``S``); a rank resumes from its own result.  On one card the
solvers run at p = 1 in one process (a one-rank NCCL group), where every
window degenerates to the whole operator.
"""

from __future__ import annotations

import torch

from hybrid_gmres_tpu_torch.krylov.arnoldi import column_major
from hybrid_gmres_tpu_torch.parallel.mesh import Mesh
from hybrid_gmres_tpu_torch.parallel.panels import (
    ShardedPanels,
    gather_window,
    local_matvec,
    local_rmatvec_window,
    scatter_window_to_full,
    shard_bucketed_panels,
    shard_view,
)
from hybrid_gmres_tpu_torch.parallel.sharded import _default_mesh, pnorm
from hybrid_gmres_tpu_torch.parallel.sharded_full import ShardedArnoldi
from hybrid_gmres_tpu_torch.solvers.common import GMRESResult
from hybrid_gmres_tpu_torch.solvers.gmres import (
    _make_project_solve,
    _restarted,
)
from hybrid_gmres_tpu_torch.utils.checkpoint import (
    check_fingerprint,
    check_resumable,
    pad_state,
    resume_fingerprint,
)

__all__ = [
    "ShardedPanels",
    "shard_bucketed_panels",
    "ba_gmres_sharded_pallas",
    "ab_gmres_sharded_pallas",
    "ba_gmres_sharded_pallas_restarted",
    "ab_gmres_sharded_pallas_restarted",
]


def _validate(A_panels, BT_panels, mesh, B_panels=None):
    p = mesh.size
    m, n = A_panels.shape
    if BT_panels is None and B_panels is None:
        raise ValueError("need BT_panels (transposed layout) or B_panels "
                         "(forward layout) for the back-projector")
    if BT_panels is not None and BT_panels.shape != (m, n):
        raise ValueError(
            f"BT panels must cover the transposed back-projector as (m, n)="
            f"{(m, n)}; got {BT_panels.shape}")
    if B_panels is not None and B_panels.shape != (n, m):
        raise ValueError(
            f"B panels must cover the back-projector as (n, m)={(n, m)}; "
            f"got {B_panels.shape}")
    for nm, pl in (("A", A_panels), ("BT", BT_panels), ("B", B_panels)):
        if pl is not None and pl.p != p:
            raise ValueError(f"{nm} panels built for p={pl.p}, mesh has {p}")
    if m % p or n % p:
        raise ValueError(f"mesh size {p} must divide m={m} and n={n}")
    return p, m, n


def _on_device(mesh, *panels):
    """This rank's :func:`~panels.shard_view` of each panel (None stays
    None) on the mesh's device: a copy from the host for host-built
    panels, the panels themselves for a view already there."""
    return tuple(None if pl is None else shard_view(pl, mesh.index,
                                                    mesh.device)
                 for pl in panels)


def _operators(A_panels, BT_panels, B_panels, mesh, dtype, comm_dtype):
    """This rank's ``A_mv`` (n-sharded x -> its rows of A x) and ``B_mv``
    (m-sharded u -> its n/p slab of B u, forward or transposed layout),
    each on its shard, on the mesh's device."""
    b_forward = B_panels is not None
    A_loc, B_loc = _on_device(mesh, A_panels,
                              B_panels if b_forward else BT_panels)

    def A_mv(x_loc):
        x_win = gather_window(A_loc, x_loc, mesh, comm_dtype)
        return local_matvec(A_loc, x_win).to(dtype)

    if b_forward:
        def B_mv(u_loc):
            u_win = gather_window(B_loc, u_loc, mesh, comm_dtype)
            return local_matvec(B_loc, u_win).to(dtype)
    else:
        def B_mv(u_loc):
            part = local_rmatvec_window(B_loc, u_loc)
            full = scatter_window_to_full(B_loc, part).to(dtype)
            return mesh.reduce_scatter(full)
    return A_mv, B_mv


class _Setup:
    """What the solvers prepare: this rank's slices of ``b`` (its slab
    along ``m_mesh``; a ``b`` of the slab's length is taken as the slab),
    ``x_true`` and ``x0`` (along ``n_mesh``; the same mesh on the 1-D
    tier, the per-axis sub-meshes on the 2-D one), the fingerprint, and
    the checkpoint to resume from."""

    def __init__(self, b, x_true, x0, lam, resume_from, m_mesh, n_mesh, m,
                 n, maxit, need):
        self.mloc, self.nloc = m // m_mesh.size, n // n_mesh.size
        self.rows_m = slice(m_mesh.index * self.mloc,
                            (m_mesh.index + 1) * self.mloc)
        self.rows_n = slice(n_mesh.index * self.nloc,
                            (n_mesh.index + 1) * self.nloc)
        dev = m_mesh.device
        b = torch.as_tensor(b, device=dev)
        self.dtype = dtype = b.dtype
        like = dict(dtype=dtype, device=dev)
        if b.shape[0] not in (m, self.mloc):
            raise ValueError(f"b has {b.shape[0]} rows; the operator has "
                             f"{m} (this rank's slab {self.mloc})")
        self.b_loc = b if b.shape[0] == self.mloc else b[self.rows_m]
        self.have_xt = x_true is not None
        xt = (torch.zeros(n, **like) if x_true is None
              else torch.as_tensor(x_true, **like))
        self.xt_loc = xt[self.rows_n]
        self.fp = resume_fingerprint(x0, lam, device=dev)
        self.have_x0 = x0 is not None
        x0 = torch.zeros(n, **like) if x0 is None else torch.as_tensor(
            x0, **like)
        self.x0_loc = x0[self.rows_n]
        self.rs = None
        self.k0 = 0
        if resume_from is not None:
            missing = [f for f in need if getattr(resume_from, f) is None]
            if missing:
                raise ValueError("resume_from must come from this solver "
                                 f"(missing .{'/.'.join(missing)})")
            check_fingerprint(resume_from, x0 if self.have_x0 else None, lam)
            check_resumable(resume_from)
            self.k0 = int(resume_from.niters)
            if self.k0 >= maxit:
                raise ValueError(f"resume needs maxit > {self.k0}")
            # exhausted budgets resume active, stopped runs inactive
            self.active = (bool(resume_from.active)
                           if resume_from.active is not None
                           else self.k0 == resume_from.res_hist.shape[0])
            self.rs = pad_state(resume_from, maxit)


def ba_gmres_sharded_pallas(
    A_panels: ShardedPanels,
    BT_panels: ShardedPanels | None,
    b,
    x_true=None,
    tol: float = 1e-6,
    maxit: int = 50,
    lam=None,
    gcv_grid=None,
    mesh: Mesh | None = None,
    axis: str = "rows",
    x0=None,
    resume_from: GMRESResult | None = None,
    B_panels: ShardedPanels | None = None,
    comm_dtype=None,
) -> GMRESResult:
    """Sharded (hybrid) BA-GMRES with the redesigned K1/K3 on every shard.

    ``A_panels``: ``shard_bucketed_panels(A_csr, p)``.  ``BT_panels``: the
    panels of B^T's ray-major rows, ``shard_bucketed_panels(B.T.tocsr(),
    p)``: B is applied through K3 and its partial reduce-scattered onto the
    n-sharded basis.  ``B_panels``: optional forward-layout panels of B's
    own pixel rows (``shard_bucketed_panels(B_csr, p)``): B then runs
    through K1 after a gather of the m-sharded intermediate;
    ``BT_panels`` may be None.  ``comm_dtype`` (e.g. ``torch.bfloat16``):
    the gathered slabs cross the wire in that type (local compute stays
    float32; expect a ~4e-3 band against the float32 exchange).
    ``lam``: None, a scalar, or ``"gcv"`` (the per-iteration GCV-optimal
    lambda over ``gcv_grid``, replicated on every rank).  ``x0``: a full
    (replicated) warm start, ``r0 = B (b - A x0)``, ``x = x0 + Q y``.
    ``resume_from``: this rank's result of an earlier call (same ``x0`` and
    ``lam``): its basis slab, Hessenberg and image slab ``.IMG`` continue
    the recurrence.  ``axis``: the mesh's axis name when ``mesh`` is None
    (a mesh over all ranks on the card)."""
    mesh = _default_mesh(mesh, axis)
    maxit = int(maxit)
    p, m, n = _validate(A_panels, BT_panels, mesh, B_panels)
    s = _Setup(b, x_true, x0, lam, resume_from, mesh, mesh, m, n, maxit,
               ("IMG",))
    A_mv, B_mv = _operators(A_panels, BT_panels, B_panels, mesh, s.dtype,
                            comm_dtype)
    return _ba_loop(s, mesh, mesh, A_mv, B_mv, n, maxit, tol, lam, gcv_grid)


def _pair_norms(m_mesh, n_mesh, r_loc, d_loc):
    """The norms of an m-sharded and an n-sharded slab: one fused
    all_reduce when one mesh holds both spaces (the 1-D tier), one sum
    over each space's axis on the 2-D tier."""
    if m_mesh is n_mesh:
        sq = m_mesh.all_reduce(torch.stack([torch.dot(r_loc, r_loc),
                                            torch.dot(d_loc, d_loc)]))
        return torch.sqrt(sq[0]), torch.sqrt(sq[1])
    return pnorm(m_mesh, r_loc), pnorm(n_mesh, d_loc)


def _ba_loop(s, m_mesh, n_mesh, A_mv, B_mv, n, maxit, tol, lam, gcv_grid):
    """The sharded BA-GMRES loop on this rank's slabs, for every tier: the
    n-sharded basis expanded over ``n_mesh``, the images ``A q_k`` kept
    m-sharded (``.IMG``) for the TRUE residual, the residual summed over
    ``m_mesh`` and the error over ``n_mesh`` (the same mesh on the 1-D
    tier, the per-axis sub-meshes on the 2-D one)."""
    dtype, dev = s.dtype, n_mesh.device
    b_norm = pnorm(m_mesh, s.b_loc)
    xt_norm = pnorm(n_mesh, s.xt_loc)
    rhs_loc = s.b_loc - A_mv(s.x0_loc) if s.have_x0 else s.b_loc
    st = ShardedArnoldi(n_mesh, s.nloc, maxit, s.x0_loc, dtype, dev)
    IMG = column_major(s.mloc, maxit, dtype, dev)
    if s.rs is None:
        st.start(B_mv(rhs_loc))
    else:
        st.resume(s.rs, s.k0, s.active)
        st.x = s.rs.x.to(dtype)[s.rows_n].clone()
        IMG.copy_(s.rs.IMG)
    # trace_dim = n for BA (gcv_function.m:46-50)
    ps = _make_project_solve(lam, n, gcv_grid)
    for k in range(s.k0, maxit):
        img_loc = A_mv(st.Q[:, k])
        IMG[:, k] = img_loc
        breakdown = st.expand(k, B_mv(img_loc))
        kdim = k + 1
        y = ps(st.H, None, st.t, kdim)[:kdim]
        xk_loc = s.x0_loc + st.Q[:, :kdim] @ y
        r_norm, d_norm = _pair_norms(m_mesh, n_mesh,
                                     rhs_loc - IMG[:, :kdim] @ y,
                                     xk_loc - s.xt_loc)
        st.adopt(k, xk_loc, r_norm / b_norm, d_norm / xt_norm, breakdown,
                 tol)
    return _finish(s, st, n_mesh, IMG=IMG)


def _finish(s, st, mesh, **bases):
    """The result: the replicated x, the histories (a resumed run's begin
    with its checkpoint's), this rank's slabs of the bases."""
    err = st.err_hist if s.have_xt else torch.full_like(st.err_hist,
                                                        float("nan"))
    return GMRESResult(mesh.all_gather(st.x), err, st.res_hist,
                       st.niters, st.Q, st.H, st.beta, active=st.active,
                       fp=s.fp, **bases)


def ab_gmres_sharded_pallas(
    A_panels: ShardedPanels,
    BT_panels: ShardedPanels | None,
    b,
    x_true=None,
    tol: float = 1e-6,
    maxit: int = 50,
    lam=None,
    gcv_grid=None,
    mesh: Mesh | None = None,
    axis: str = "rows",
    x0=None,
    resume_from: GMRESResult | None = None,
    B_panels: ShardedPanels | None = None,
    comm_dtype=None,
) -> GMRESResult:
    """Sharded (hybrid) AB-GMRES: the m-space basis sharded over the rays,
    the redesigned K1/K3 on every shard.  The images ``s_k = B q_k`` stay
    n-sharded (``.S``) and ``w_k = A s_k`` m-sharded (``.IMG``), so the
    solution ``x = x0 + S y`` and the TRUE residual ``||b - W y||`` need no
    extra collective.  Arguments, layouts and resume as in
    :func:`ba_gmres_sharded_pallas` (a resume needs ``.IMG`` and ``.S``)."""
    mesh = _default_mesh(mesh, axis)
    maxit = int(maxit)
    p, m, n = _validate(A_panels, BT_panels, mesh, B_panels)
    s = _Setup(b, x_true, x0, lam, resume_from, mesh, mesh, m, n, maxit,
               ("IMG", "S"))
    A_mv, B_mv = _operators(A_panels, BT_panels, B_panels, mesh, s.dtype,
                            comm_dtype)
    return _ab_loop(s, mesh, mesh, A_mv, B_mv, m, maxit, tol, lam, gcv_grid)


def _ab_loop(s, m_mesh, n_mesh, A_mv, B_mv, m, maxit, tol, lam, gcv_grid):
    """The sharded AB-GMRES loop on this rank's slabs, for every tier: the
    m-sharded basis expanded over ``m_mesh``, the images ``S`` n-sharded
    and ``W`` m-sharded; sums as in :func:`_ba_loop`."""
    dtype, dev = s.dtype, m_mesh.device
    b_norm = pnorm(m_mesh, s.b_loc)
    xt_norm = pnorm(n_mesh, s.xt_loc)
    rhs_loc = s.b_loc - A_mv(s.x0_loc) if s.have_x0 else s.b_loc
    st = ShardedArnoldi(m_mesh, s.mloc, maxit, s.x0_loc, dtype, dev)
    S = column_major(s.nloc, maxit, dtype, dev)
    W = column_major(s.mloc, maxit, dtype, dev)
    if s.rs is None:
        st.start(rhs_loc)
    else:
        st.resume(s.rs, s.k0, s.active)
        st.x = s.rs.x.to(dtype)[s.rows_n].clone()
        W.copy_(s.rs.IMG)
        S.copy_(s.rs.S)
    # trace_dim = m for AB (gcv_function.m:46-50)
    ps = _make_project_solve(lam, m, gcv_grid)
    for k in range(s.k0, maxit):
        s_loc = B_mv(st.Q[:, k])
        w_loc = A_mv(s_loc)
        S[:, k] = s_loc
        W[:, k] = w_loc
        breakdown = st.expand(k, w_loc)
        kdim = k + 1
        y = ps(st.H, None, st.t, kdim)[:kdim]
        xk_loc = s.x0_loc + S[:, :kdim] @ y
        r_norm, d_norm = _pair_norms(m_mesh, n_mesh,
                                     rhs_loc - W[:, :kdim] @ y,
                                     xk_loc - s.xt_loc)
        st.adopt(k, xk_loc, r_norm / b_norm, d_norm / xt_norm, breakdown,
                 tol)
    return _finish(s, st, n_mesh, IMG=W, S=S)


def ba_gmres_sharded_pallas_restarted(
    A_panels, BT_panels, b, x_true=None, tol: float = 1e-6,
    restart: int = 20, max_restarts: int = 10, lam=None, gcv_grid=None,
    mesh: Mesh | None = None, axis: str = "rows", B_panels=None,
) -> GMRESResult:
    """Restarted sharded BA-GMRES(restart): cycles of ``restart`` steps,
    each warm-started from the last cycle's (replicated) solution; the
    outer loop is the single-chip ``solvers/gmres._restarted``.  The
    rank's shards go to the device once, for all the cycles."""
    mesh = _default_mesh(mesh, axis)
    A_panels, BT_panels, B_panels = _on_device(mesh, A_panels, BT_panels,
                                               B_panels)
    return _restarted(
        lambda x0: ba_gmres_sharded_pallas(
            A_panels, BT_panels, b, x_true, tol=tol, maxit=int(restart),
            lam=lam, gcv_grid=gcv_grid, mesh=mesh, x0=x0,
            B_panels=B_panels),
        max_restarts, tol)


def ab_gmres_sharded_pallas_restarted(
    A_panels, BT_panels, b, x_true=None, tol: float = 1e-6,
    restart: int = 20, max_restarts: int = 10, lam=None, gcv_grid=None,
    mesh: Mesh | None = None, axis: str = "rows", B_panels=None,
) -> GMRESResult:
    """Restarted sharded AB-GMRES(restart) (see the BA twin)."""
    mesh = _default_mesh(mesh, axis)
    A_panels, BT_panels, B_panels = _on_device(mesh, A_panels, BT_panels,
                                               B_panels)
    return _restarted(
        lambda x0: ab_gmres_sharded_pallas(
            A_panels, BT_panels, b, x_true, tol=tol, maxit=int(restart),
            lam=lam, gcv_grid=gcv_grid, mesh=mesh, x0=x0,
            B_panels=B_panels),
        max_restarts, tol)
