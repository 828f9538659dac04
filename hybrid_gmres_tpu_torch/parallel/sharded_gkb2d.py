"""Golub–Kahan family over the 2-D (ray x pixel) tiled mesh (PyTorch port
of ``hybrid_gmres_tpu/parallel/sharded_gkb2d.py``; the functions keep its
names).

The 2-D twins of ``sharded_gkb.py`` (reference recurrences
``lsqr_solver.m:20-47``, ``hybrid_lsqr_solver.m:21-46``,
``lsmr_solver.m:32-77``, ``hybrid_lsmr_solver.m:26-45``) on
:class:`~panels2d.TiledPanels`:

  * u-space (ray) vectors sharded over "rows" (replicated over "cols"),
    v-space (image) vectors over "cols" (replicated over "rows");
  * each half-step makes ONE collective: K1r on the tile and a sum over
    "cols" (m/pr values) or K3r and a sum over "rows" (n/pc values); the
    exact adjoint pair comes from the same tile's two forms (quantized
    tiles share one global ``diag(s) Q``);
  * norms and the CGS2 passes of ``reorth=True`` sum over the vector's own
    axis only; the augmented u-space of the hybrid LSQR (rays and pixels)
    sums each part over its axis, and ``||A||_F^2`` is the tiles' masses
    summed over both.

The recurrences are the single-chip cores, through the 1-D tier's bodies,
with the sums of the two spaces injected (``reduce`` over "rows",
``reduce_v`` over "cols"): a fix there reaches all three tiers.  SPMD as
in ``panels2d.py``: every rank passes the same tiles (or its own
:func:`~panels2d.tile_view`), the full ``b``/``x_true``/``x0``, and gets
the replicated ``x`` and histories; ``.state`` holds this rank's slabs,
and ``resume(run(k), K)`` equals ``run(K)`` (not for the hybrid LSMR, as
in the JAX package).
"""

from __future__ import annotations

from hybrid_gmres_tpu_torch.parallel.mesh import Mesh
from hybrid_gmres_tpu_torch.parallel.panels2d import (
    TiledPanels,
    _axes,
    _on_device_2d,
    tiled_local_ops,
)
from hybrid_gmres_tpu_torch.parallel.sharded_gkb import (
    _check_modes,
    _hybrid_lsmr,
    _hybrid_lsqr,
    _Local,
    _lsmr,
    _lsqr,
    _Vectors,
)
from hybrid_gmres_tpu_torch.solvers.common import GKBResult

__all__ = [
    "lsqr_sharded_2d",
    "hybrid_lsqr_sharded_2d",
    "lsmr_sharded_2d",
    "hybrid_lsmr_sharded_2d",
]


def _prep2d(A, b, x_true, x0, maxit, mesh, axes):
    """The checks, this rank's ``_Vectors`` (b over "rows", x over
    "cols") and its tile's operator: ``fro_sq`` the tiles' masses summed
    over both axes (two collectives)."""
    if mesh is None or len(mesh.shape) != 2:
        raise ValueError("the 2-D GKB solvers require an explicit 2-D mesh "
                         "(make_mesh_2d)")
    if not isinstance(A, TiledPanels):
        raise TypeError("A must be TiledPanels (tile_bucketed_panels)")
    if (A.pr, A.pc) != tuple(mesh.shape) or A.transposed:
        raise ValueError(f"tiles built for {A.pr}x{A.pc}, mesh is "
                         f"{mesh.shape[0]}x{mesh.shape[1]}")
    m, n = A.shape
    maxit = min(m, n) if maxit is None else int(maxit)
    rows, cols = _axes(mesh, axes)
    v = _Vectors(b, x_true, x0, rows, cols, m, n)
    (A_loc,) = _on_device_2d(mesh, A)
    matvec, rmatvec, fro_sq = tiled_local_ops(A_loc, mesh, v.dtype, axes)
    op = _Local(matvec, rmatvec, A.tile_shape,
                rows.all_reduce(cols.all_reduce(fro_sq)))
    return op, v, n, maxit


def lsqr_sharded_2d(
    A: TiledPanels,
    b,
    x_true=None,
    tol: float = 1e-6,
    maxit: int | None = None,
    mesh: Mesh | None = None,
    axes=("rows", "cols"),
    x0=None,
    resume_from=None,
    reorth: bool = False,
) -> GKBResult:
    """2-D tiled LSQR (``lsqr_solver.m:20-47``: the cheap residual estimate,
    the last entry patched to the true residual).  ``x0``: an optional
    full warm start (the GKB runs on ``b - A x0``).  ``resume_from``: this
    rank's ``.state`` of an earlier call (same ``x0``/``reorth``; its
    histories unpatched).  ``reorth=True``: CGS2 against the stored bases
    (U over "rows", V over "cols")."""
    op, v, _, maxit = _prep2d(A, b, x_true, x0, maxit, mesh, axes)
    return _lsqr(op, v, maxit, tol, resume_from, reorth)


def hybrid_lsqr_sharded_2d(
    A: TiledPanels,
    b,
    x_true=None,
    tol: float = 1e-6,
    maxit: int | None = None,
    lam: float = 1e-3,
    mesh: Mesh | None = None,
    axes=("rows", "cols"),
    x0=None,
    resume_from=None,
    reorth: bool = False,
) -> GKBResult:
    """2-D tiled LSQR on the augmented ``[A; sqrt(lam) I]``
    (``hybrid_lsqr_solver.m:5-6``): the ``sqrt(lam) I`` block is
    col-shard diagonal (no communication); the augmented u-vector is this
    rank's m/pr rays and n/pc pixels, each part summed over its axis; the
    residual is tracked against the unaugmented system
    (``hybrid_lsqr_solver.m:43``).  ``x0``: the exact Tikhonov warm start
    of the single-chip ``hybrid_lsqr``.  ``resume_from``/``reorth`` as in
    :func:`lsqr_sharded_2d` (same ``lam``)."""
    op, v, _, maxit = _prep2d(A, b, x_true, x0, maxit, mesh, axes)
    return _hybrid_lsqr(op, v, maxit, tol, lam, resume_from, reorth)


def lsmr_sharded_2d(
    A: TiledPanels,
    b,
    x_true=None,
    tol: float = 1e-6,
    maxit: int | None = None,
    mesh: Mesh | None = None,
    axes=("rows", "cols"),
    x0=None,
    resume_from=None,
    reorth: bool = False,
) -> GKBResult:
    """2-D tiled LSMR (``lsmr_solver.m:32-77``) with the true residual and
    ``||A^T r||`` histories (``||A||_F`` exact, from the tiles' masses).
    ``x0``/``resume_from``/``reorth`` as in :func:`lsqr_sharded_2d`."""
    op, v, _, maxit = _prep2d(A, b, x_true, x0, maxit, mesh, axes)
    return _lsmr(op, v, maxit, tol, resume_from, reorth)


def hybrid_lsmr_sharded_2d(
    A: TiledPanels,
    b,
    x_true=None,
    tol: float = 1e-6,
    maxit: int | None = None,
    lam=1e-3,
    rank1_mode: str = "last",
    mesh: Mesh | None = None,
    axes=("rows", "cols"),
    gcv_grid=None,
    x0=None,
    x0_reg: str = "correction",
    reorth: bool = False,
) -> GKBResult:
    """2-D tiled hybrid LSMR: the right basis V over "cols", the bidiagonal
    and the shifted projected solve (``hybrid_lsmr_solver.m:37-45``)
    replicated; ``lam`` a scalar or ``"gcv"`` (per step, no collective).
    ``x0``/``x0_reg``: the single-chip ``hybrid_lsmr``'s two warm-start
    semantics (``"full"``: one sum over "cols" a step for ``V^T x0``).
    ``reorth=True``: CGS2 of both bases."""
    _check_modes(rank1_mode, x0_reg)
    op, v, n, maxit = _prep2d(A, b, x_true, x0, maxit, mesh, axes)
    return _hybrid_lsmr(op, v, n, maxit, tol, lam, rank1_mode, gcv_grid,
                        reorth, x0_reg)
