"""2-D tiled multi-RHS (batched) hybrid BA/AB-GMRES (PyTorch port of
``hybrid_gmres_tpu/parallel/sharded_batched2d.py``; the functions keep its
names).

R independent hybrid reconstructions through the 2-D (ray x pixel) tiles
of ``parallel/panels2d.py``: every Krylov product is a multi-RHS tile
product (K2r forward, K4r on the form of the transpose: one read of the
form serves a tile of 8 columns), and a step's collectives are the
single-RHS 2-D solver's, each carrying R columns: one sum over "cols" for
A (m/pr x R), one over "rows" for B (n/pc x R), one fused sum per CGS2 pass
((k+1, R) coefficients) over the basis's axis, the norms each over its
space's axis.  Their count does not depend on R.

Per-RHS semantics are those of ``ba_gmres_batched``/``ab_gmres_batched``
(independent Arnoldi recurrences, projected solves, histories, active
flags and warm starts; not block GMRES): the loop is the single-chip one
through the 1-D tier's :func:`~sharded_batched._mesh_batched_core`, with
the 2-D mesh's sums injected.  SPMD as in ``panels2d.py``: every rank
passes the full ``b`` (m, R), ``x_true`` and ``x0``, and gets the
replicated ``x`` (n, R), the histories and its slabs of ``Q``, ``IMG``
and ``S``; a rank resumes from its own result.
"""

from __future__ import annotations

import torch

from hybrid_gmres_tpu_torch.parallel.mesh import Mesh
from hybrid_gmres_tpu_torch.parallel.panels2d import (
    TiledPanels,
    _axes,
    _make_B_2d,
    _on_device_2d,
    _validate_2d,
    tiled_local_mms,
)
from hybrid_gmres_tpu_torch.parallel.sharded_batched import (
    _mesh_reductions,
    _run_batched,
)
from hybrid_gmres_tpu_torch.solvers.common import GMRESResult

__all__ = [
    "ba_gmres_sharded_batched_2d",
    "ab_gmres_sharded_batched_2d",
]


def _sharded_batched_2d(kind, A_tiles, BT_tiles, b, x_true, tol, maxit,
                        lam, gcv_grid, mesh, axes, x0, B_tiles, chunk_rhs,
                        defer_histories, resume_from):
    pr, pc, m, n = _validate_2d(A_tiles, BT_tiles, mesh, B_tiles)
    rows, cols = _axes(mesh, axes)
    b_forward = B_tiles is not None
    A_loc, B_loc = _on_device_2d(mesh, A_tiles,
                                 B_tiles if b_forward else BT_tiles)
    b = torch.as_tensor(b, device=mesh.device)
    A_mm = tiled_local_mms(A_loc, mesh, b.dtype, axes)[0]
    B_mm = _make_B_2d(tiled_local_mms, B_loc, b_forward, mesh, b.dtype,
                      axes)
    # m-space sums over "rows", n-space over "cols"; the Krylov basis
    # lives in n-space (BA) or m-space (AB)
    basis = cols if kind == "ba" else rows
    red = _mesh_reductions(rows, cols, basis)
    return _run_batched(kind, A_mm, B_mm, red, rows, cols, m, n, b, x_true,
                        tol, maxit, lam, gcv_grid, x0, chunk_rhs,
                        defer_histories, resume_from)


def ba_gmres_sharded_batched_2d(
    A_tiles: TiledPanels,
    BT_tiles: TiledPanels | None,
    b,
    x_true=None,
    tol: float = 0.0,
    maxit: int = 50,
    lam=None,
    gcv_grid=None,
    mesh: Mesh | None = None,
    axes=("rows", "cols"),
    x0=None,
    B_tiles: TiledPanels | None = None,
    chunk_rhs: int | None = 8,
    defer_histories: bool = False,
    resume_from: GMRESResult | None = None,
) -> GMRESResult:
    """2-D tiled multi-RHS (hybrid) BA-GMRES over R right-hand sides.

    ``b``: (m, R), the full array on every rank.  Per RHS the results match
    ``ba_gmres_batched``; the collectives of a step are the single-RHS
    ``ba_gmres_sharded_pallas_2d``'s, whatever R.  ``x0``: an optional
    (n, R) (or (n,) broadcast) per-RHS warm start.  ``chunk_rhs``: R is
    split into solves of at most this many columns (default 8; None: one).
    ``defer_histories``: the Arnoldi-only loop and the post-loop solves and
    histories of the single-chip deferred mode (``lam="gcv-final"`` needs
    it).  ``B_tiles``: the forward-layout back-projector
    (``tile_backprojector_forward``).  ``resume_from``: this rank's result
    of an earlier call of this solver (same ``x0``/``lam``/``chunk_rhs``;
    fingerprint-checked; in-loop mode only)."""
    return _sharded_batched_2d("ba", A_tiles, BT_tiles, b, x_true, tol,
                               maxit, lam, gcv_grid, mesh, axes, x0, B_tiles,
                               chunk_rhs, defer_histories, resume_from)


def ab_gmres_sharded_batched_2d(
    A_tiles: TiledPanels,
    BT_tiles: TiledPanels | None,
    b,
    x_true=None,
    tol: float = 0.0,
    maxit: int = 50,
    lam=None,
    gcv_grid=None,
    mesh: Mesh | None = None,
    axes=("rows", "cols"),
    x0=None,
    B_tiles: TiledPanels | None = None,
    chunk_rhs: int | None = 8,
    defer_histories: bool = False,
    resume_from: GMRESResult | None = None,
) -> GMRESResult:
    """2-D tiled multi-RHS (hybrid) AB-GMRES: the m/pr bases over "rows",
    the solutions from the col-sharded images ``S = B Q``.  See
    :func:`ba_gmres_sharded_batched_2d`."""
    return _sharded_batched_2d("ab", A_tiles, BT_tiles, b, x_true, tol,
                               maxit, lam, gcv_grid, mesh, axes, x0, B_tiles,
                               chunk_rhs, defer_histories, resume_from)
