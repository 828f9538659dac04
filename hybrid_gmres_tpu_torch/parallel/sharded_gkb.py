"""Row-sharded Golub–Kahan family: LSQR, LSMR and their hybrids (PyTorch
port of ``hybrid_gmres_tpu/parallel/sharded_gkb.py``; the functions keep
its names).

The distributed twins of ``solvers/lsqr.py`` and ``solvers/lsmr.py``
(reference ``lsqr_solver.m:20-47``, ``hybrid_lsqr_solver.m:21-46``,
``lsmr_solver.m:32-77``, ``hybrid_lsmr_solver.m:26-45``):

  * A is row-partitioned over the mesh: dense slabs of the full (m, n)
    array, :class:`~panels.ShardedPanels` (the redesigned K1 on each
    shard's forward form, K3 on the form of its transpose),
    :class:`~panels.PanelsWithAdjoint` (K1 on both) or
    :class:`~panels.ComposedPanels` (``A B`` or ``B A``);
  * u-space (ray) vectors are m-sharded, v-space (image) vectors
    n-sharded; each half-step makes one collective (the forward product
    gathers the n-sharded v, windowed or by all_gather; the adjoint
    reduce-scatters its partial, or gathers u for an adjoint panel), and
    every norm one all_reduce;
  * the recurrences are the single-chip ones (``lsqr._lsqr_core``,
    ``lsmr._lsmr_core``, ``lsmr._hybrid_lsmr_core``) run on this rank's
    slabs with the sum over the mesh injected (``reduce``), including the
    CGS2 purification of ``reorth=True`` (one fused all_reduce a pass).

SPMD: every rank passes the same ``A`` (the full dense array, host-built
panels or its own :func:`~panels.shard_view`), the full ``b``, ``x_true``
and ``x0``; it gets the replicated ``x`` and histories.  The checkpoint
(``.state``) holds this rank's slabs: a rank resumes from its own result,
and ``resume(run(k), K)`` equals ``run(K)``.
"""

from __future__ import annotations

import torch

from hybrid_gmres_tpu_torch.ops.linear_operator import AugmentedOperator
from hybrid_gmres_tpu_torch.parallel.mesh import Mesh
from hybrid_gmres_tpu_torch.parallel.panels import (
    ComposedPanels,
    PanelsWithAdjoint,
    ShardedPanels,
    composed_local_ops,
    gather_window,
    local_matvec,
    local_rmatvec_window,
    scatter_window_to_full,
    shard_view,
)
from hybrid_gmres_tpu_torch.parallel.sharded import _default_mesh, pnorm
from hybrid_gmres_tpu_torch.solvers.common import (
    GKBResult,
    GKBState,
    SplitSum,
)
from hybrid_gmres_tpu_torch.solvers.lsmr import (
    _hybrid_lsmr_core,
    _lsmr_core,
    make_hybrid_lsmr_lam_fn,
)
from hybrid_gmres_tpu_torch.solvers.lsqr import (
    _lsqr_core,
    patch_true_residual,
)
from hybrid_gmres_tpu_torch.utils.checkpoint import (
    check_fingerprint,
    resume_fingerprint,
)
from hybrid_gmres_tpu_torch.utils.device import scalar_tensor

__all__ = [
    "lsqr_sharded",
    "hybrid_lsqr_sharded",
    "lsmr_sharded",
    "hybrid_lsmr_sharded",
]

_PANELS = (ShardedPanels, PanelsWithAdjoint, ComposedPanels)


class _Local:
    """This rank's operator as the GKB cores see it: ``matvec`` (n-sharded
    v -> its m/p rows of A v), ``rmatvec`` (m-sharded u -> its n/p slab of
    A^T u), ``shape`` (m/p, n/p) and ``fro_sq`` (``||A||_F^2``, NaN for a
    composed operator)."""

    def __init__(self, matvec, rmatvec, shape, fro_sq):
        self.matvec, self.rmatvec = matvec, rmatvec
        self.shape, self.fro_sq = shape, fro_sq


def _prep(A, maxit, mesh, axis):
    mesh = _default_mesh(mesh, axis)
    p = mesh.size
    if not isinstance(A, _PANELS):
        A = torch.as_tensor(A)
    m, n = A.shape
    if isinstance(A, _PANELS) and A.p != p:
        raise ValueError(f"panels built for p={A.p}, mesh has {p}")
    if m % p or n % p:
        raise ValueError(f"mesh size {p} must divide m={m} and n={n}")
    return mesh, A, m, n, min(m, n) if maxit is None else int(maxit)


def _local_ops(A, mesh, dtype) -> _Local:
    """This rank's products in the four operator shapes of the JAX
    ``_local_ops``; panels go to the mesh's device once, a view already
    there as it is."""
    p, i, dev = mesh.size, mesh.index, mesh.device
    m, n = A.shape
    shape = (m // p, n // p)
    like = dict(dtype=dtype, device=dev)
    if isinstance(A, ComposedPanels):
        # ||M||_F is not cheaply available (NaN, as for the single-chip
        # matrix-free operators)
        mv, rmv = composed_local_ops(shard_view(A, i, dev), mesh, dtype)
        return _Local(mv, rmv, shape, torch.full((), float("nan"), **like))
    if isinstance(A, PanelsWithAdjoint):
        # the forward-layout adjoint: K1 on the AT shard after a gather of
        # the m-sharded u, no reduction
        pair = shard_view(A, i, dev)
        Ap, ATp = pair.A, pair.AT
        scale = Ap.shards[0].row_scale

        def matvec(v_loc):
            return local_matvec(Ap, gather_window(Ap, v_loc, mesh)).to(dtype)

        def rmatvec(u_loc):
            if scale is not None:
                # the shared-quantization int8 pair: A^T u = Q^T (s u), the
                # AT shard holds the raw Q^T and the scales ride the input
                u_loc = scale * u_loc.to(torch.float32)
            return local_matvec(ATp, gather_window(ATp, u_loc, mesh)).to(
                dtype)

        return _Local(matvec, rmatvec, shape, A.fro_sq.sum().to(**like))
    if isinstance(A, ShardedPanels):
        view = shard_view(A, i, dev)

        def matvec(v_loc):
            return local_matvec(view, gather_window(view, v_loc, mesh)).to(
                dtype)

        def rmatvec(u_loc):
            part = local_rmatvec_window(view, u_loc)
            return mesh.reduce_scatter(
                scatter_window_to_full(view, part).to(dtype))

        # the exact per-shard ||A_slab||_F^2 of the build, whatever the
        # storage type
        return _Local(matvec, rmatvec, shape, A.fro_sq.sum().to(**like))
    A_loc = A[i * shape[0]:(i + 1) * shape[0]].to(**like)
    return _Local(lambda v_loc: A_loc @ mesh.all_gather(v_loc),
                  lambda u_loc: mesh.reduce_scatter(A_loc.T @ u_loc), shape,
                  mesh.all_reduce((A_loc * A_loc).sum()))


class _Vectors:
    """This rank's slabs of the full ``b`` (along ``m_mesh``), ``x_true``
    and ``x0`` (along ``n_mesh``; ``x0`` also whole, for the fingerprint) on
    the mesh's device, the sums over each space, the norms of ``b`` and
    ``x_true``, and the sharded relative error.  The 1-D tier passes its
    mesh for both spaces; the 2-D tier its "rows" and "cols" sub-meshes."""

    def __init__(self, b, x_true, x0, m_mesh, n_mesh, m, n):
        dev = m_mesh.device
        self.m_mesh, self.n_mesh, self.device = m_mesh, n_mesh, dev
        b = torch.as_tensor(b, device=dev)
        self.dtype = b.dtype
        like = dict(dtype=b.dtype, device=dev)
        mloc, nloc = m // m_mesh.size, n // n_mesh.size
        self.rows_n = slice(n_mesh.index * nloc, (n_mesh.index + 1) * nloc)
        self.b_loc = b[m_mesh.index * mloc:(m_mesh.index + 1) * mloc]
        self.have_xt = x_true is not None
        xt = (torch.zeros(n, **like) if x_true is None
              else torch.as_tensor(x_true, **like))
        self.xt_loc = xt[self.rows_n]
        self.x0 = None if x0 is None else torch.as_tensor(x0, **like)
        self.x0_loc = None if x0 is None else self.x0[self.rows_n]
        self.sum_m, self.sum_n = m_mesh.all_reduce, n_mesh.all_reduce
        self.b_norm = pnorm(m_mesh, self.b_loc)
        self.xt_norm = pnorm(n_mesh, self.xt_loc)

    def sum_aug(self, mloc):
        """The sum over the augmented u-space ``[m-slab; n-slab]`` of the
        hybrid LSQR: one collective on one mesh, two on a 2-D one."""
        if self.m_mesh is self.n_mesh:
            return self.sum_m
        return SplitSum(mloc, self.sum_m, self.sum_n)

    def at(self, d_loc):
        """The iterate of the correction ``d_loc`` (``x0 + d``)."""
        return d_loc if self.x0_loc is None else self.x0_loc + d_loc

    def error_fn(self, d_loc):
        """The relative error of the iterate ``x0 + d`` (one all_reduce;
        made without ``x_true`` too, so every rank issues it alike)."""
        return pnorm(self.n_mesh, self.at(d_loc) - self.xt_loc) / \
            self.xt_norm

    def result(self, x_loc, err_hist, res_hist, niters, **extra):
        """The replicated result: ``x`` gathered, the error history NaN
        without ``x_true``."""
        if not self.have_xt:
            err_hist = torch.full_like(err_hist, float("nan"))
        return GKBResult(x=self.n_mesh.all_gather(x_loc), err_hist=err_hist,
                         res_hist=res_hist, niters=niters, **extra)


# The solvers' bodies, shared by the 1-D tier (here) and the 2-D one
# (``sharded_gkb2d.py``): ``op`` is this rank's operator (``_Local``), ``v``
# its ``_Vectors``.

def _lsqr(op, v, maxit, tol, resume_from, reorth):
    if resume_from is not None:
        check_fingerprint(resume_from, v.x0, None)
    fp = resume_fingerprint(v.x0, None, device=v.device)
    b_iter = v.b_loc if v.x0 is None else v.b_loc - op.matvec(v.x0_loc)
    d, res_hist, err_hist, niters, carry = _lsqr_core(
        op, b_iter, None, v.error_fn, v.b_norm, maxit, tol, reorth=reorth,
        resume_from=resume_from, reduce=v.sum_m, reduce_v=v.sum_n)
    x = v.at(d)
    state = GKBState(carry=carry, res_hist=res_hist, err_hist=err_hist,
                     fp=fp)
    # the true residual for the last entry (lsqr_solver.m:52)
    true_res = pnorm(v.m_mesh, v.b_loc - op.matvec(x)) / v.b_norm
    return v.result(x, err_hist,
                    patch_true_residual(res_hist, niters, true_res), niters,
                    state=state)


def _hybrid_lsqr(op, v, maxit, tol, lam, resume_from, reorth):
    aug = AugmentedOperator(op, lam)
    if v.x0 is None:
        b_aug = aug.augment_rhs(v.b_loc)
    else:
        sqlam = torch.sqrt(scalar_tensor(lam, v.dtype, v.device))
        b_aug = torch.cat([v.b_loc - op.matvec(v.x0_loc),
                           -sqlam * v.x0_loc])
    if resume_from is not None:
        check_fingerprint(resume_from, v.x0, lam)
    fp = resume_fingerprint(v.x0, lam, device=v.device)

    def residual_fn(d_loc):
        return pnorm(v.m_mesh, v.b_loc - op.matvec(v.at(d_loc))) / v.b_norm

    d, res_hist, err_hist, niters, carry = _lsqr_core(
        aug, b_aug, residual_fn, v.error_fn, v.b_norm, maxit, tol,
        reorth=reorth, resume_from=resume_from,
        reduce=v.sum_aug(op.shape[0]), reduce_v=v.sum_n)
    state = GKBState(carry=carry, res_hist=res_hist, err_hist=err_hist,
                     fp=fp)
    return v.result(v.at(d), err_hist, res_hist, niters, state=state)


def _lsmr(op, v, maxit, tol, resume_from, reorth):
    if resume_from is not None:
        check_fingerprint(resume_from, v.x0, None)
    fp = resume_fingerprint(v.x0, None, device=v.device)
    # the core carries the whole iterate: the error needs no offset
    r = _lsmr_core(op, v.b_loc, v.x0_loc, v.b_norm, torch.sqrt(op.fro_sq),
                   lambda x: pnorm(v.n_mesh, x - v.xt_loc) / v.xt_norm,
                   maxit, tol, reorth, resume_from, fp, reduce=v.sum_m,
                   reduce_v=v.sum_n)
    return v.result(r.x, r.err_hist, r.res_hist, r.niters,
                    ar_hist=r.ar_hist, state=r.state)


def _check_modes(rank1_mode, x0_reg):
    """The hybrid LSMR's mode arguments, checked before any collective."""
    if rank1_mode not in ("last", "first"):
        raise ValueError("rank1_mode must be 'last' or 'first'")
    if x0_reg not in ("correction", "full"):
        raise ValueError("x0_reg must be 'correction' or 'full'")


def _hybrid_lsmr(op, v, n, maxit, tol, lam, rank1_mode, gcv_grid, reorth,
                 x0_reg):
    lam_fn = make_hybrid_lsmr_lam_fn(lam, gcv_grid, n, maxit, v.dtype,
                                     v.device)
    b_iter = v.b_loc if v.x0 is None else v.b_loc - op.matvec(v.x0_loc)
    d, state = _hybrid_lsmr_core(
        op, v.b_loc, b_iter, v.b_norm, v.error_fn, lam_fn, maxit, tol,
        rank1_mode, reorth, None, v.x0_loc if x0_reg == "full" else None,
        None, reduce=v.sum_m, reduce_v=v.sum_n)
    return v.result(v.at(d), state.err_hist, state.res_hist, state.carry[7])


def lsqr_sharded(
    A,
    b,
    x_true=None,
    tol: float = 1e-6,
    maxit: int | None = None,
    mesh: Mesh | None = None,
    axis: str = "rows",
    resume_from=None,
    x0=None,
    reorth: bool = False,
) -> GKBResult:
    """Sharded LSQR (``lsqr_solver.m:20-47``: the cheap residual estimate
    ``|phi_bar| / ||b||`` with the last entry patched to the true
    residual).  ``A``: a dense (m, n) array, :class:`ShardedPanels`,
    :class:`PanelsWithAdjoint` or :class:`ComposedPanels`.

    ``resume_from``: this rank's ``.state`` of an earlier call (same
    ``x0``/``reorth``); its histories are the unpatched ones, the patch is
    made again after the resume.  ``x0``: an optional full (replicated)
    warm start: the GKB runs on ``b - A x0`` for the correction.
    ``reorth=True``: full CGS2 reorthogonalization against the sharded
    stored bases (U m-sharded, V n-sharded; one fused all_reduce a pass)."""
    mesh, A, m, n, maxit = _prep(A, maxit, mesh, axis)
    v = _Vectors(b, x_true, x0, mesh, mesh, m, n)
    return _lsqr(_local_ops(A, mesh, v.dtype), v, maxit, tol, resume_from,
                 reorth)


def hybrid_lsqr_sharded(
    A,
    b,
    x_true=None,
    tol: float = 1e-6,
    maxit: int | None = None,
    lam: float = 1e-3,
    mesh: Mesh | None = None,
    axis: str = "rows",
    x0=None,
    resume_from=None,
    reorth: bool = False,
) -> GKBResult:
    """Sharded LSQR on the Tikhonov-augmented system ``[A; sqrt(lam) I]``
    (``hybrid_lsqr_solver.m:5-6``).  This rank's slab of the augmented
    u-vector is its m/p rays followed by its n/p pixels (the ``sqrt(lam)
    I`` block is shard-diagonal: no communication); the residual is
    tracked against the unaugmented system every step
    (``hybrid_lsqr_solver.m:43``, one more product).

    ``x0``: the exact Tikhonov warm start of the single-chip
    ``hybrid_lsqr`` (augmented GKB on ``[b - A x0; -sqrt(lam) x0]``,
    ``x = x0 + d``).  ``resume_from``: this rank's ``.state`` (same
    ``x0``/``lam``/``reorth``).  ``reorth=True``: CGS2 against the
    augmented U and the V bases."""
    mesh, A, m, n, maxit = _prep(A, maxit, mesh, axis)
    v = _Vectors(b, x_true, x0, mesh, mesh, m, n)
    return _hybrid_lsqr(_local_ops(A, mesh, v.dtype), v, maxit, tol, lam,
                        resume_from, reorth)


def lsmr_sharded(
    A,
    b,
    x_true=None,
    tol: float = 1e-6,
    maxit: int | None = None,
    mesh: Mesh | None = None,
    axis: str = "rows",
    x0=None,
    resume_from=None,
    reorth: bool = False,
) -> GKBResult:
    """Sharded LSMR (``lsmr_solver.m:32-77``): GKB and two layers of plane
    rotations, with the true residual and ``||A^T r||`` histories every
    step (``||A||_F`` from the build's per-shard values, or one all_reduce
    of the dense slabs').  ``x0``/``resume_from``/``reorth`` as in
    :func:`lsqr_sharded`."""
    mesh, A, m, n, maxit = _prep(A, maxit, mesh, axis)
    v = _Vectors(b, x_true, x0, mesh, mesh, m, n)
    return _lsmr(_local_ops(A, mesh, v.dtype), v, maxit, tol, resume_from,
                 reorth)


def hybrid_lsmr_sharded(
    A,
    b,
    x_true=None,
    tol: float = 1e-6,
    maxit: int | None = None,
    lam=1e-3,
    rank1_mode: str = "last",
    mesh: Mesh | None = None,
    axis: str = "rows",
    gcv_grid=None,
    reorth: bool = False,
    x0=None,
    x0_reg: str = "correction",
) -> GKBResult:
    """Sharded hybrid LSMR: the GKB with the right basis V n-sharded, the
    bidiagonal and the per-step shifted projected solve
    (``hybrid_lsmr_solver.m:37-45``) replicated.

    ``lam``: a scalar, or ``"gcv"`` (the per-step GCV pick on the
    replicated projected problem: every rank picks the same lambda with no
    collective).  ``x0``/``x0_reg``: the warm start in the single-chip
    ``hybrid_lsmr``'s two regularizer semantics (``"full"`` costs one
    fused all_reduce a step for ``V^T x0``).  ``reorth=True``: CGS2 of
    both sharded bases."""
    _check_modes(rank1_mode, x0_reg)
    mesh, A, m, n, maxit = _prep(A, maxit, mesh, axis)
    v = _Vectors(b, x_true, x0, mesh, mesh, m, n)
    return _hybrid_lsmr(_local_ops(A, mesh, v.dtype), v, n, maxit, tol, lam,
                        rank1_mode, gcv_grid, reorth, x0_reg)
