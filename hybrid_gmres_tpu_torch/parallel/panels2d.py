"""2-D (ray x pixel) tiled panels and the 2-D BA/AB-GMRES (PyTorch port of
``hybrid_gmres_tpu/parallel/panels2d.py``; the functions keep its names).

A 1-D row partition of the CT pair cannot move fewer than O(n) values per
iteration: every fan of rays crosses the whole image.  Here the operator is
tiled over a (pr x pc) mesh of ray slabs by pixel slabs, so that the
per-iteration traffic is O(m/pr + n/pc) and falls in both mesh dimensions.
Rank (i, j) of the mesh (axes "rows" = pr, "cols" = pc) holds:

  * tile (i, j) of A, A[rows_i, cols_j], read forward: its columns are
    tile-local, so the input of the product is this rank's n-slab itself
    (no gather), and one sum over the "cols" axis completes the rows;
  * tile (i, j) of B^T (``BT_tiles``), read through the form of its
    transpose: B u is one sum over the "rows" axis of the partials; or,
    with ``B_tiles`` (:func:`tile_backprojector_forward`), tile (j, i) of
    B's own (pc x pr) grid read forward, with the same one sum over
    "rows";
  * n-space vectors sharded over "cols" (replicated over "rows"), m-space
    vectors sharded over "rows" (replicated over "cols").

Each tile is a :class:`~panels.PanelShard`: the single-chip packer's panel
of the tile, kept as the two row-packed forms the redesigned kernels read
(K1r/K2r forward, K3r/K4r on the form of the transpose), with offset 0 and
tile-local columns.  Where the JAX package pads every tile to mesh-uniform
buckets under a leading device axis and un-sorts rows inside the product,
the forms hold their rows in source order with their own lanes.  int8 and
int4 tiles share ONE per-row quantization ``A ~= diag(s) Q`` of the whole
operator: the tile products run unscaled, and the scales are applied after
the sum over "cols" (forward) or to ``u`` before the sum over "rows"
(transposed), so the sums reduce integer-matrix images.

The solvers are SPMD like those of ``sharded_rows.py``: every rank passes
the host-built tiles or its own :func:`tile_view`, the full ``b`` and
``x_true``, and gets the replicated ``x`` (gathered over "cols"), the
histories, and its slabs of the bases.  The Arnoldi expansion is
``ShardedArnoldi`` on the basis's axis (BA: the n/pc basis over "cols";
AB: the m/pr basis over "rows").  On one card the mesh is (1, 1): every
sum is a one-rank NCCL call.

Reference hot loop at scale: ``BAgmres_hybrid_bounds.m:24-40``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from hybrid_gmres_tpu_torch.ops.sparse import bucketed_block_ell_from_csr
from hybrid_gmres_tpu_torch.ops.spmv_cuda import (
    _row_quantize_csr,
    row_matmat,
    row_matvec,
    row_rmatmat,
    row_rmatvec,
)
from hybrid_gmres_tpu_torch.parallel.mesh import Mesh
from hybrid_gmres_tpu_torch.parallel.panels import _panel_dtype, _shard_forms
from hybrid_gmres_tpu_torch.parallel.sharded_rows import (
    _ab_loop,
    _ba_loop,
    _Setup,
)
from hybrid_gmres_tpu_torch.solvers.common import GMRESResult
from hybrid_gmres_tpu_torch.solvers.gmres import _restarted

__all__ = [
    "TiledPanels",
    "tile_bucketed_panels",
    "tile_backprojector_forward",
    "ba_gmres_sharded_pallas_2d",
    "ab_gmres_sharded_pallas_2d",
    "ba_gmres_sharded_pallas_2d_restarted",
    "ab_gmres_sharded_pallas_2d_restarted",
    "comms_bytes_per_iteration_2d",
]


@dataclass
class TiledPanels:
    """The tiles of an operator over a (pr x pc) grid.

    ``tiles``: :class:`~panels.PanelShard` s in the mesh's row-major order
    (tile of mesh rank ``i * mesh_pc + j`` at index ``i * mesh_pc + j``),
    all of them (:func:`tile_bucketed_panels`) or one (a :func:`tile_view`,
    the tile of index ``first``).  Static: ``shape`` (m, n) of the tiled
    matrix, ``pr``/``pc`` its own grid (for ``B_tiles`` B's (pc, pr) grid
    of the mesh: ``transposed=True``), ``fro_sq`` (pr*pc,) each tile's
    exact ``||tile||_F^2`` of the source matrix (mesh order), ``packed4``,
    ``block_shape``, ``row_group`` of the packing."""

    tiles: tuple
    shape: tuple
    pr: int
    pc: int
    block_shape: tuple
    row_group: int = 8
    packed4: bool = False
    fro_sq: torch.Tensor | None = None
    transposed: bool = False
    first: int = 0

    @property
    def mesh_shape(self) -> tuple:
        """The (rows, cols) shape of the mesh these tiles are laid on."""
        return (self.pc, self.pr) if self.transposed else (self.pr, self.pc)

    @property
    def tile_shape(self) -> tuple:
        return (self.shape[0] // self.pr, self.shape[1] // self.pc)

    @property
    def nbytes(self) -> int:
        return sum(t.nbytes for t in self.tiles)

    def local(self, i: int, j: int, device=None):
        """The tile of mesh rank (i, j), on ``device`` when given."""
        d = i * self.mesh_shape[1] + j
        if len(self.tiles) == self.pr * self.pc:
            tile = self.tiles[d]
        elif len(self.tiles) == 1 and self.first == d:
            tile = self.tiles[0]
        else:
            raise ValueError(f"these panels hold tile {self.first} of "
                             f"{self.pr * self.pc}, not tile {d}")
        return tile if device is None else tile.to(device)


def tile_bucketed_panels(csr, pr: int, pc: int, block=(8, 128),
                         dtype=np.float32, n_buckets: int = 4,
                         row_group: int = 8) -> TiledPanels:
    """Tile ``csr`` (m, n) over a (pr x pc) grid, pack every tile with the
    single-chip bucketed packer and keep it as its two forms (tile-local
    columns, rows in source order), on the host.

    ``dtype``: float32, bfloat16, int8 or int4 (numpy or torch dtype or
    name).  int8/int4 quantize per GLOBAL row once, before tiling (``qmax``
    127 / 7): the tiles of a row slab share its scales.  ``fro_sq`` is taken
    from the source matrix before any quantization."""
    m, n = csr.shape
    if m % pr or n % pc:
        raise ValueError(f"grid {pr}x{pc} must divide m={m}, n={n}")
    csr = csr.tocsr()
    mloc, nloc = m // pr, n // pc
    fro = np.zeros(pr * pc, np.float32)
    for i in range(pr):
        slab = csr[i * mloc:(i + 1) * mloc].tocsc()
        for j in range(pc):
            tile = slab[:, j * nloc:(j + 1) * nloc]
            fro[i * pc + j] = float((tile.multiply(tile)).sum())
    dt, is_int4, quantized = _panel_dtype(dtype)
    scales = [None] * pr
    if quantized:
        csr, s = _row_quantize_csr(csr, qmax=7 if is_int4 else 127)
        scales = [torch.as_tensor(s[i * mloc:(i + 1) * mloc])
                  for i in range(pr)]
    tiles = []
    for i in range(pr):
        slab = csr[i * mloc:(i + 1) * mloc].tocsc()
        for j in range(pc):
            bell = bucketed_block_ell_from_csr(
                slab[:, j * nloc:(j + 1) * nloc].tocsr(), block=block,
                dtype=dt, n_buckets=n_buckets, row_group=row_group,
                pack_int4=is_int4, device="cpu")
            tiles.append(_shard_forms(bell, scales[i], 0, 0, bell.shape,
                                      bell.ncb))
    return TiledPanels(tiles=tuple(tiles), shape=(m, n), pr=pr, pc=pc,
                       block_shape=tuple(block), row_group=row_group,
                       packed4=is_int4, fro_sq=torch.as_tensor(fro))


def tile_backprojector_forward(B_csr, pr: int, pc: int,
                               **kw) -> TiledPanels:
    """Forward-layout back-projector tiles for a (pr x pc) ray x pixel
    mesh: rank (i, j) holds B[pixel slab j, ray slab i], so ``B u`` runs
    the FORWARD kernels on the local tile (its columns are exactly this
    rank's u slab) followed by the same sum over "rows" the transposed
    layout makes: a kernel-speed trade with no extra collective.

    B (n, m) is tiled on its own (pc, pr) grid and its tile (j, i) placed
    at mesh rank (i, j); the metadata keeps B's grid (``pr`` is the mesh's
    pc, ``transposed=True``).  ``kw``: as :func:`tile_bucketed_panels`."""
    tp = tile_bucketed_panels(B_csr, pc, pr, **kw)
    order = [j * pr + i for i in range(pr) for j in range(pc)]
    return dataclasses.replace(tp, tiles=tuple(tp.tiles[d] for d in order),
                               fro_sq=tp.fro_sq[order], transposed=True)


def tile_view(tp: TiledPanels, i: int, j: int, device=None) -> TiledPanels:
    """The tiles with mesh rank (i, j)'s alone (on ``device`` when given):
    what a rank hands to a solver, made once (host-built tiles are copied
    to the device at every call), and how one tile of a larger grid is
    driven on one card.  A tile already on ``device`` is used as it is."""
    d = i * tp.mesh_shape[1] + j
    return dataclasses.replace(tp, tiles=(tp.local(i, j, device),), first=d)


# ---------------------------------------------------------------------------
# Tile-local products, UNSCALED: the row scales of quantized tiles are
# applied outside them (after the sum over "cols", or to u before the sum
# over "rows"); see tiled_local_ops.  Each takes a tile_view.
# ---------------------------------------------------------------------------

def tile_matvec(tp: TiledPanels, x_loc):
    """The partial (m/pr,) ``Q_tile x_loc`` through K1r on the tile's
    forward form; the sum over "cols" completes the rows."""
    return row_matvec(tp.tiles[0].fwd_rows, x_loc)


def tile_rmatvec(tp: TiledPanels, u_loc, scale=None):
    """The partial (n/pc,) ``Q_tile^T (scale * u_loc)`` through K3r on the
    form of the tile's transpose, ``scale`` gathered beside ``u`` inside
    the kernel; the sum over "rows" completes the columns."""
    return row_rmatvec(tp.tiles[0].adj_rows, u_loc, scale)


def tile_matmat(tp: TiledPanels, X_loc):
    """Multi-RHS :func:`tile_matvec`: (m/pr, R) through K2r, one read of the
    form a tile of 8 columns, column j bit-equal to K1r on column j."""
    return row_matmat(tp.tiles[0].fwd_rows, X_loc)


def tile_rmatmat(tp: TiledPanels, U_loc, scale=None):
    """Multi-RHS :func:`tile_rmatvec`: (n/pc, R) through K4r, column j
    bit-equal to K3r on column j."""
    return row_rmatmat(tp.tiles[0].adj_rows, U_loc, scale)


def _axes(mesh: Mesh, axes):
    """The mesh's two per-axis sub-meshes (rows, cols)."""
    return tuple(mesh.axis(a) for a in axes)


def tiled_local_ops(tp: TiledPanels, mesh: Mesh, dtype, axes=("rows",
                                                              "cols")):
    """(matvec, rmatvec, fro_sq) of this rank's tile (a :func:`tile_view`
    on the mesh's device): the exact adjoint pair the GKB family needs.

    matvec: col-sharded v (n/pc,) -> row-sharded u (m/pr,), the partial
    summed over "cols", then scaled by the row scales; rmatvec: row-sharded
    u -> col-sharded v, u scaled first (inside K3r), the partial summed
    over "rows".  ``fro_sq``: this tile's ``||A_tile||_F^2`` (the caller
    sums it over both axes for ``||A||_F^2``).  ``axes``: the names of the
    ray and pixel axes; swapped, the products of a tile laid on the mesh
    transposed (a forward-B tile) sum over the other axis."""
    rows, cols = _axes(mesh, axes)
    scale = tp.tiles[0].row_scale

    def matvec(v_loc):
        y = cols.all_reduce(tile_matvec(tp, v_loc))
        if scale is not None:
            y = scale * y
        return y.to(dtype)

    def rmatvec(u_loc):
        return rows.all_reduce(tile_rmatvec(tp, u_loc, scale)).to(dtype)

    fro_sq = tp.fro_sq[tp.first].to(dtype=dtype, device=mesh.device)
    return matvec, rmatvec, fro_sq


def tiled_local_mms(tp: TiledPanels, mesh: Mesh, dtype, axes=("rows",
                                                              "cols")):
    """(matmat, rmatmat): the multi-RHS twins of :func:`tiled_local_ops`
    (K2r, K4r), one sum per product whatever R."""
    rows, cols = _axes(mesh, axes)
    scale = tp.tiles[0].row_scale

    def matmat(V_loc):
        Y = cols.all_reduce(tile_matmat(tp, V_loc))
        if scale is not None:
            Y = scale[:, None] * Y
        return Y.to(dtype)

    def rmatmat(U_loc):
        return rows.all_reduce(tile_rmatmat(tp, U_loc, scale)).to(dtype)

    return matmat, rmatmat


def comms_bytes_per_iteration_2d(A_tiles: TiledPanels,
                                 itemsize: int = 4,
                                 kdim: int = 0) -> dict:
    """Analytic per-iteration bytes per rank of the 2-D BA schedule (ring
    all-reduce ~= 2 (p-1)/p bytes per element), the JAX package's dict
    exactly: O(m/pr + n/pc), falling in BOTH mesh dimensions.  Scalar
    reductions are priced per axis: the loop makes two on "cols" (the new
    column's norm, the error) and one on "rows" (the residual)."""
    m, n = A_tiles.shape
    pr, pc = A_tiles.pr, A_tiles.pc
    red_m = 2.0 * (pc - 1) / pc * (m // pr) * itemsize
    red_n = 2.0 * (pr - 1) / pr * (n // pc) * itemsize
    allred_ac = 2.0 * (pc - 1) / pc * itemsize   # col-axis ring factor
    allred_ar = 2.0 * (pr - 1) / pr * itemsize   # row-axis ring factor
    cgs2 = 2 * (kdim + 1) * allred_ac            # CGS2 rides the col axis
    scalars_ac = 2 * allred_ac                   # hnorm, err_k
    scalars_ar = 1 * allred_ar                   # res_k (m-space)
    return {
        "pr": pr, "pc": pc,
        "A_reduce_bytes": red_m,
        "B_reduce_bytes": red_n,
        "cgs2_bytes": cgs2,
        "scalar_bytes_col_axis": scalars_ac,
        "scalar_bytes_row_axis": scalars_ar,
        "scalar_bytes": scalars_ac + scalars_ar,
        "total_bytes": red_m + red_n + cgs2 + scalars_ac + scalars_ar,
    }


def _validate_2d(A_tiles, BT_tiles, mesh, B_tiles=None):
    if mesh is None or len(mesh.shape) != 2:
        raise ValueError("requires an explicit 2-D mesh (make_mesh_2d)")
    pr, pc = mesh.shape
    m, n = A_tiles.shape
    if BT_tiles is None and B_tiles is None:
        raise ValueError("need BT_tiles (transposed layout) or B_tiles "
                         "(forward layout, tile_backprojector_forward)")
    if BT_tiles is not None and BT_tiles.shape != (m, n):
        raise ValueError(f"BT tiles must cover B^T as (m, n)={(m, n)}; got "
                         f"{BT_tiles.shape}")
    grids = [(A_tiles.pr, A_tiles.pc)] + (
        [] if BT_tiles is None else [(BT_tiles.pr, BT_tiles.pc)])
    if any(g != (pr, pc) for g in grids):
        raise ValueError(f"tiles built for "
                         f"{' / '.join(f'{a}x{b}' for a, b in grids)}, "
                         f"mesh is {pr}x{pc}")
    if B_tiles is not None and (
            B_tiles.shape != (n, m) or (B_tiles.pr, B_tiles.pc) != (pc, pr)
            or not B_tiles.transposed):
        # forward tiles carry B's OWN grid: (pc, pr) of the mesh
        raise ValueError(
            f"B tiles must cover B as (n, m)={(n, m)} on a {pc}x{pr} grid "
            f"(tile_backprojector_forward); got {B_tiles.shape} on "
            f"{B_tiles.pr}x{B_tiles.pc}")
    return pr, pc, m, n


def _on_device_2d(mesh, *tiles):
    """This rank's :func:`tile_view` of each tiling (None stays None) on
    the mesh's device."""
    return tuple(None if tp is None else tile_view(tp, *mesh.coords,
                                                   mesh.device)
                 for tp in tiles)


def _make_B_2d(local, B_loc, b_forward, mesh, dtype, axes):
    """This rank's product with B, row-sharded u -> col-sharded B u, one
    sum over "rows" in both layouts.  ``local``: :func:`tiled_local_ops`
    (the single-RHS product) or :func:`tiled_local_mms` (multi-RHS).  The
    BT tile runs its transposed product; a
    :func:`tile_backprojector_forward` tile, whose grid is the mesh's
    transposed, runs the forward product with the axes swapped, so that
    it sums over "rows" and then applies B's pixel-row scales."""
    if b_forward:
        return local(B_loc, mesh, dtype, tuple(axes)[::-1])[0]
    return local(B_loc, mesh, dtype, axes)[1]


def _setup_2d(kind, A_tiles, BT_tiles, B_tiles, b, x_true, x0, lam,
              resume_from, mesh, axes, maxit):
    """What both 2-D solvers prepare: the checks, this rank's slices
    (``b`` by its row coordinate, x by its column coordinate), the
    checkpoint (the 1-D ``_Setup``: the same fields, fingerprint and
    padding), the per-axis sub-meshes and the tile products."""
    pr, pc, m, n = _validate_2d(A_tiles, BT_tiles, mesh, B_tiles)
    rows, cols = _axes(mesh, axes)
    s = _Setup(b, x_true, x0, lam, resume_from, rows, cols, m, n, maxit,
               ("IMG", "S") if kind == "ab" else ("IMG",))
    b_forward = B_tiles is not None
    A_loc, B_loc = _on_device_2d(mesh, A_tiles,
                                 B_tiles if b_forward else BT_tiles)
    A_mv = tiled_local_ops(A_loc, mesh, s.dtype, axes)[0]
    B_mv = _make_B_2d(tiled_local_ops, B_loc, b_forward, mesh, s.dtype,
                      axes)
    return s, rows, cols, m, n, A_mv, B_mv


def ba_gmres_sharded_pallas_2d(
    A_tiles: TiledPanels,
    BT_tiles: TiledPanels | None,
    b,
    x_true=None,
    tol: float = 1e-6,
    maxit: int = 50,
    lam=None,
    gcv_grid=None,
    mesh: Mesh | None = None,
    axes=("rows", "cols"),
    B_tiles: TiledPanels | None = None,
    x0=None,
    resume_from: GMRESResult | None = None,
) -> GMRESResult:
    """(Hybrid) BA-GMRES over a 2-D mesh with K1r/K3r on every tile.

    ``A_tiles``: :func:`tile_bucketed_panels` of A.  ``BT_tiles``: the
    tiles of ``B.T.tocsr()`` (ray-major, the compressible direction), read
    through K3r.  ``B_tiles``: optional forward-layout tiles
    (:func:`tile_backprojector_forward`), read through K1r; ``BT_tiles``
    may then be None.  ``lam``: None, a scalar or ``"gcv"`` (the
    per-iteration GCV-optimal lambda over ``gcv_grid``, replicated, no
    extra collective).  ``x0``: an optional full warm start (``r0 = B (b -
    A x0)``, ``x = x0 + Q y``; one more tile product at setup).
    ``resume_from``: this rank's result of an earlier call (same ``x0`` and
    ``lam``): its basis slab, Hessenberg and row-sharded images ``.IMG``
    continue the recurrence.  ``mesh``: a :func:`~mesh.make_mesh_2d` mesh
    (required); ``axes``: the names of its ray and pixel axes.  Per
    iteration: one sum over "cols" for A, one over "rows" for B, two CGS2
    sums, the new column's norm and the error over "cols", the residual
    over "rows"."""
    maxit = int(maxit)
    s, rows, cols, m, n, A_mv, B_mv = _setup_2d(
        "ba", A_tiles, BT_tiles, B_tiles, b, x_true, x0, lam, resume_from,
        mesh, axes, maxit)
    return _ba_loop(s, rows, cols, A_mv, B_mv, n, maxit, tol, lam, gcv_grid)


def ab_gmres_sharded_pallas_2d(
    A_tiles: TiledPanels,
    BT_tiles: TiledPanels | None,
    b,
    x_true=None,
    tol: float = 1e-6,
    maxit: int = 50,
    lam=None,
    gcv_grid=None,
    mesh: Mesh | None = None,
    axes=("rows", "cols"),
    B_tiles: TiledPanels | None = None,
    x0=None,
    resume_from: GMRESResult | None = None,
) -> GMRESResult:
    """(Hybrid) AB-GMRES over the 2-D tiles: the m/pr basis expanded over
    "rows", the images ``s_k = B q_k`` col-sharded (``.S``) and ``w_k = A
    s_k`` row-sharded (``.IMG``), so ``x = x0 + S y`` and the TRUE residual
    ``||b - W y||`` need no extra product.  Arguments as in
    :func:`ba_gmres_sharded_pallas_2d` (a resume needs ``.IMG`` and
    ``.S``)."""
    maxit = int(maxit)
    s, rows, cols, m, n, A_mv, B_mv = _setup_2d(
        "ab", A_tiles, BT_tiles, B_tiles, b, x_true, x0, lam, resume_from,
        mesh, axes, maxit)
    return _ab_loop(s, rows, cols, A_mv, B_mv, m, maxit, tol, lam, gcv_grid)


def ba_gmres_sharded_pallas_2d_restarted(
    A_tiles, BT_tiles, b, x_true=None, tol: float = 1e-6,
    restart: int = 20, max_restarts: int = 10, lam=None, gcv_grid=None,
    mesh: Mesh | None = None, axes=("rows", "cols"), B_tiles=None,
) -> GMRESResult:
    """Restarted 2-D BA-GMRES(restart): cycles of ``restart`` steps, each
    warm-started from the last cycle's (replicated) solution; the outer
    loop is the single-chip ``solvers/gmres._restarted``.  The rank's
    tiles go to the device once, for all the cycles."""
    if mesh is None:
        raise ValueError("requires an explicit 2-D mesh (make_mesh_2d)")
    A_tiles, BT_tiles, B_tiles = _on_device_2d(mesh, A_tiles, BT_tiles,
                                               B_tiles)
    return _restarted(
        lambda x0: ba_gmres_sharded_pallas_2d(
            A_tiles, BT_tiles, b, x_true, tol=tol, maxit=int(restart),
            lam=lam, gcv_grid=gcv_grid, mesh=mesh, axes=axes,
            B_tiles=B_tiles, x0=x0),
        max_restarts, tol)


def ab_gmres_sharded_pallas_2d_restarted(
    A_tiles, BT_tiles, b, x_true=None, tol: float = 1e-6,
    restart: int = 20, max_restarts: int = 10, lam=None, gcv_grid=None,
    mesh: Mesh | None = None, axes=("rows", "cols"), B_tiles=None,
) -> GMRESResult:
    """Restarted 2-D AB-GMRES(restart) (see the BA twin)."""
    if mesh is None:
        raise ValueError("requires an explicit 2-D mesh (make_mesh_2d)")
    A_tiles, BT_tiles, B_tiles = _on_device_2d(mesh, A_tiles, BT_tiles,
                                               B_tiles)
    return _restarted(
        lambda x0: ab_gmres_sharded_pallas_2d(
            A_tiles, BT_tiles, b, x_true, tol=tol, maxit=int(restart),
            lam=lam, gcv_grid=gcv_grid, mesh=mesh, axes=axes,
            B_tiles=B_tiles, x0=x0),
        max_restarts, tol)
