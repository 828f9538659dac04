"""Row-sharded panels with static column windows (PyTorch port).

Twin of the 1-D parts of ``hybrid_gmres_tpu/parallel/panels.py``.  The CSR
rows are cut into ``p`` contiguous slabs, each packed with the single-chip
bucketed block-ELL packer (``ops/sparse.py``), and the static column window
of every slab is worked out exactly as the JAX package does:

  * **Static column windows.**  Per shard, the contiguous run of x-slabs
    (``n / p`` columns each) its panel touches.  When the union of the
    needed exchange shifts is smaller than the mesh, the input of the
    forward product is assembled from ``L`` shifts (``ppermute``, here
    ``Mesh.shift``) instead of one ``all_gather``: ``L * n/p`` values on the
    wire instead of ``(p-1) * n/p``.  Column indices are stored
    window-relative.
  * **Reduce-scatter.**  The transposed product's window-relative partial
    is placed in the global frame (:func:`scatter_window_to_full`) and one
    ``reduce_scatter`` lands it on the n-sharded basis.

Where the JAX package stacks the shards' panels, padded to mesh-uniform
shapes, under a leading device axis, the port keeps each shard as two
row-packed forms with window-relative columns (:class:`PanelShard`): the
forward form for the redesigned K1 (``row_matvec``) and the form of its
transpose for the redesigned K3 (``row_rmatvec``), both in
``csrc/row_spmv.cu``.  The bucket padding does not reach the forms, so each
shard's forms have their own lanes.  :func:`shard_bucketed_panels` builds
all shards on the host; a rank puts only its own on its device
(:func:`shard_view`).

``PanelsWithAdjoint``, ``build_panels_with_adjoint``, ``ComposedPanels`` and
the multi-RHS primitives (``gather_window_mat``, ``local_matmat``,
``local_rmatmat_window``, ``scatter_window_to_full_mat``) come with the
sharded GKB and batched solvers (ROADMAP).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from hybrid_gmres_tpu_torch.ops.sparse import (
    BucketedBlockELL,
    RowPacked,
    bucketed_block_ell_from_csr,
    row_packed_from_bell,
)
from hybrid_gmres_tpu_torch.ops.spmv_cuda import (
    _row_quantize_csr,
    row_matvec,
    row_rmatvec,
)


@dataclass
class PanelShard:
    """One shard of a :class:`ShardedPanels`: its rows of A as the forward
    form (``(m/p, window)``, window-relative columns) and the form of the
    transpose (``(window, m/p)``), the int8/int4 row scales of its rows
    (None for float panels) and the first x-slab of its window."""

    fwd_rows: RowPacked
    adj_rows: RowPacked
    row_scale: torch.Tensor | None
    win_start: int

    def to(self, device) -> "PanelShard":
        return dataclasses.replace(
            self, fwd_rows=self.fwd_rows.to(device),
            adj_rows=self.adj_rows.to(device),
            row_scale=None if self.row_scale is None
            else self.row_scale.to(device))

    @property
    def nbytes(self) -> int:
        return self.fwd_rows.nbytes + self.adj_rows.nbytes


@dataclass
class ShardedPanels:
    """The shards of a row-partitioned operator, with the static window
    description the exchange needs.

    ``shards``: every shard (as :func:`shard_bucketed_panels` builds them)
    or one (a :func:`shard_view`), the first of them shard ``first``.
    Static: ``shape`` (global m, n), ``ncb`` (global block columns),
    ``win_slabs`` (window width in slabs of n/p), ``slab_blocks`` (block
    columns per slab; 0 = no window, the shard sees all n columns),
    ``shifts`` ``(dmin, L)``: the exchange shifts ``dmin .. dmin+L-1``
    (``L == p``: one all_gather), ``p``, ``packed4`` (int4 panels),
    ``fro_sq`` (p,) float32: each slab's exact ``||A_slab||_F^2``,
    ``block_shape`` and ``row_group`` of the packing."""

    shards: tuple
    shape: tuple
    ncb: int
    win_slabs: int
    slab_blocks: int
    shifts: tuple
    p: int
    block_shape: tuple
    row_group: int = 8
    packed4: bool = False
    fro_sq: torch.Tensor | None = None
    first: int = 0

    @property
    def windowed(self) -> bool:
        return self.slab_blocks > 0

    @property
    def win_blocks(self) -> int:
        """Block columns visible to the local kernels."""
        return (self.win_slabs * self.slab_blocks if self.windowed
                else self.ncb)

    @property
    def win_len(self) -> int:
        """Length of a shard's input window: ``win_slabs * n/p`` entries,
        or all n without a window."""
        return (self.win_slabs * (self.shape[1] // self.p) if self.windowed
                else self.shape[1])

    @property
    def win_start(self) -> torch.Tensor:
        """(shards,) int32: the first x-slab of each held shard's window."""
        return torch.tensor([s.win_start for s in self.shards],
                            dtype=torch.int32)

    @property
    def row_scale(self):
        """The held shards' row scales, (shards, m/p), or None."""
        if self.shards[0].row_scale is None:
            return None
        return torch.stack([s.row_scale.cpu() for s in self.shards])

    @property
    def nbytes(self) -> int:
        return sum(s.nbytes for s in self.shards)

    def local(self, index: int, device=None) -> PanelShard:
        """Shard ``index`` (of the ``p``), on ``device`` when given."""
        if len(self.shards) == self.p:
            shard = self.shards[index]
        elif len(self.shards) == 1 and self.first == index:
            shard = self.shards[0]
        else:
            raise ValueError(
                f"these panels hold shards {self.first}.."
                f"{self.first + len(self.shards) - 1} of {self.p}, not "
                f"shard {index}")
        return shard if device is None else shard.to(device)


def _panel_dtype(dtype):
    """(packer dtype, int4?, quantized?) of a storage type given as a numpy
    or torch dtype or a name."""
    if isinstance(dtype, str):
        if dtype.lower() == "int4":
            return np.int8, True, True
        dtype = getattr(torch, dtype) if dtype == "bfloat16" else dtype
    if isinstance(dtype, torch.dtype):
        if dtype == torch.int4:
            return np.int8, True, True
        if dtype == torch.bfloat16:
            return torch.bfloat16, False, False
        dtype = {torch.float32: np.float32, torch.int8: np.int8}[dtype]
    dt = np.dtype(dtype)
    if dt.name == "bfloat16":      # ml_dtypes
        return torch.bfloat16, False, False
    return dt, False, dt == np.int8


def _live_block_columns(bell: BucketedBlockELL):
    """The block columns of a panel's nonzero blocks (int64 numpy)."""
    cols = []
    for blocks, bcols in bell.buckets:
        nz = blocks.reshape(blocks.shape[0], blocks.shape[1], -1).ne(0).any(
            dim=2)
        cols.append(bcols[nz].long().numpy())
    return np.concatenate(cols) if cols else np.zeros(0, np.int64)


def _window_relative(bell: BucketedBlockELL, offset: int, shape, ncb):
    """The panel with block columns ``c - offset`` clipped to ``[0, ncb)``
    (real blocks lie inside the window, so the clip touches padding slots
    only), logical shape ``shape`` and ``ncb`` block columns, on the
    host."""
    if offset == 0 and tuple(shape) == bell.shape and ncb == bell.ncb:
        return bell
    buckets = []
    for blocks, bcols in bell.buckets:
        blk = blocks.to(torch.float32) if blocks.dtype == torch.bfloat16 \
            else blocks
        buckets.append((blk.numpy(),
                        np.clip(bcols.numpy().astype(np.int64) - offset,
                                0, ncb - 1).astype(np.int32)))
    dtype = torch.bfloat16 if bell.dtype == torch.bfloat16 else None
    return BucketedBlockELL._from_logical(
        buckets, bell.inv_perm.numpy(), shape, ncb, bell.packed4, "cpu",
        dtype)


def _shard_forms(bell, scale, offset, win_start, shape, ncb):
    """One shard: the two forms of its window-relative panel."""
    rel = _window_relative(bell, offset, shape, ncb)
    return PanelShard(fwd_rows=row_packed_from_bell(rel),
                      adj_rows=row_packed_from_bell(rel, transpose=True),
                      row_scale=scale, win_start=int(win_start))


def _windows(panels, p, n, bc, window):
    """The JAX package's static window choice: ``(slab_blocks, S, start,
    dmin, L)`` with ``slab_blocks = 0`` when no window pays (always at
    p = 1: one shard sees all n columns)."""
    nloc = n // p if n % p == 0 else 0
    if window and p > 1 and nloc > 0 and nloc % bc == 0:
        slab_blocks = nloc // bc
        smin = np.zeros(p, np.int64)
        smax = np.zeros(p, np.int64)
        for i, pl in enumerate(panels):
            cols = _live_block_columns(pl)
            if cols.size:
                smin[i] = cols.min() // slab_blocks
                smax[i] = cols.max() // slab_blocks
        S = int((smax - smin + 1).max())
        # Window starts may run NEGATIVE or past p (slabs are fetched mod
        # p): start_i = i + e_i with e_i = clamp(e, smax_i - S + 1 - i,
        # smin_i - i) for the common offset e that minimizes the global
        # shift range L.
        ids = np.arange(p)
        lo = smax - S + 1 - ids
        hi = smin - ids
        best = None
        for e in range(int(lo.min()), int(hi.max()) + 1):
            ei = np.clip(e, lo, hi)
            Le = int(ei.max() - ei.min()) + S
            if best is None or Le < best[0]:
                best = (Le, ei)
        L, e_i = best
        if L < p:  # else one all_gather beats p shifts
            return slab_blocks, S, (ids + e_i).astype(np.int64), \
                int(e_i.min()), L
    return 0, 0, np.zeros(p, np.int64), 0, p


def shard_bucketed_panels(csr, p: int, block=(8, 128), dtype=np.float32,
                          n_buckets: int = 4, row_group: int = 8,
                          window: bool = True,
                          quantize: bool = True) -> ShardedPanels:
    """Split CSR rows into ``p`` contiguous slabs, pack each with the
    single-chip bucketed packer, work out the static column windows, and
    keep each shard as its two window-relative row-packed forms, on the
    host.

    ``dtype``: float32, bfloat16, int8 or int4 (numpy or torch dtype
    or name).  int8/int4 quantize per row once (``A ~= diag(s) Q``,
    ``qmax`` 127 / 7), shared by both forms (an exact adjoint pair);
    ``quantize=False`` stores int8 values raw (integers in [-127, 127]).
    ``window=True`` enables the windowed exchange when the column slabs are
    block-aligned (``(n/p) % bc == 0``) and the shifts it needs are fewer
    than ``p``; otherwise every shard sees all n columns through one
    all_gather."""
    m, n = csr.shape
    if m % p:
        raise ValueError(f"rows {m} not divisible by {p} shards")
    csr = csr.tocsr()
    mloc = m // p
    br, bc = block
    fro = np.zeros(p, np.float32)
    for i in range(p):
        slab = csr[i * mloc:(i + 1) * mloc]
        fro[i] = float((slab.multiply(slab)).sum())
    dt, is_int4, quantized = _panel_dtype(dtype)
    scales = [None] * p
    if quantized and quantize:
        csr, s = _row_quantize_csr(csr, qmax=7 if is_int4 else 127)
        scales = [torch.as_tensor(s[i * mloc:(i + 1) * mloc])
                  for i in range(p)]
    panels = [
        bucketed_block_ell_from_csr(
            csr[i * mloc:(i + 1) * mloc], block=block, dtype=dt,
            n_buckets=n_buckets, row_group=row_group, pack_int4=is_int4,
            device="cpu")
        for i in range(p)
    ]
    slab_blocks, S, start, dmin, L = _windows(panels, p, n, bc, window)
    sp_ = ShardedPanels(
        shards=(), shape=(m, n), ncb=panels[0].ncb, win_slabs=S,
        slab_blocks=slab_blocks, shifts=(dmin, L), p=p,
        block_shape=(br, bc), row_group=row_group, packed4=is_int4,
        fro_sq=torch.as_tensor(fro))
    return dataclasses.replace(sp_, shards=tuple(
        _shard_forms(pl, scales[i], int(start[i]) * slab_blocks, start[i],
                     (mloc, sp_.win_len), sp_.win_blocks)
        for i, pl in enumerate(panels)))


# ---------------------------------------------------------------------------
# Shard-local primitives.  Each takes panels whose first held shard is this
# rank's (a shard_view, or the panels the solver cut to this rank) and the
# mesh of the solve.
# ---------------------------------------------------------------------------

def _exchange(sp: ShardedPanels, x_loc, mesh, comm_dtype):
    """Windowed panels: ``L`` shifts and a slice of the received stack
    (``L * n/p`` values on the wire) -> this shard's window, flat; full
    panels: one all_gather ((p-1) * n/p values) -> all n.  ``comm_dtype``:
    the slab crosses the wire in this type (a cast before, float32 after)."""
    x_loc = x_loc.to(torch.float32)
    wire = x_loc if comm_dtype is None else x_loc.to(comm_dtype)
    if not sp.windowed:
        return mesh.all_gather(wire).to(torch.float32)
    dmin, L = sp.shifts
    stack = torch.stack([mesh.shift(wire, dmin + idx) for idx in range(L)])
    start_rel = sp.shards[0].win_start - mesh.index - dmin
    return stack[start_rel:start_rel + sp.win_slabs].reshape(-1).to(
        torch.float32)


def gather_window(sp: ShardedPanels, x_loc, mesh, comm_dtype=None):
    """This shard's x window, float32 and flat (``win_len``,), from the
    n-sharded x (one slab of ``n/p`` per rank).  ``comm_dtype`` (e.g.
    ``torch.bfloat16``): the exchanged slabs are rounded to it, which moves
    the result by ~4e-3 relative (hold it to a band, not to bits)."""
    return _exchange(sp, x_loc, mesh, comm_dtype)


def local_matvec(sp: ShardedPanels, x_win):
    """``A_loc x_win`` (m/p,) through the redesigned K1 on this shard's
    forward form, the row scale in its epilogue."""
    shard = sp.shards[0]
    return row_matvec(shard.fwd_rows, x_win, shard.row_scale)


def local_rmatvec_window(sp: ShardedPanels, u_loc):
    """The window-relative partial ``(A_loc)^T u_loc`` (``win_len``,)
    through the redesigned K3 on the form of this shard's transpose, the
    row scale gathered beside ``u``: reduce it over the mesh after
    :func:`scatter_window_to_full`."""
    shard = sp.shards[0]
    return row_rmatvec(shard.adj_rows, u_loc, shard.row_scale)


def scatter_window_to_full(sp: ShardedPanels, y_win):
    """A window-relative partial placed in the global (n,) frame (zero pad
    and roll: windows may start negative or wrap past n)."""
    n = sp.shape[1]
    if not sp.windowed:
        return y_win[:n]
    nloc = n // sp.p
    full = torch.zeros(n, dtype=y_win.dtype, device=y_win.device)
    full[:y_win.shape[0]] = y_win
    return torch.roll(full, sp.shards[0].win_start * nloc)


def shard_view(sp: ShardedPanels, i: int, device=None) -> ShardedPanels:
    """The panels with shard ``i`` alone (on ``device`` when given), for the
    shard-local primitives: what a rank hands to a solver, and how the
    window-relative forms of a p > 1 build are driven on one card."""
    return dataclasses.replace(sp, shards=(sp.local(i, device),), first=i)


def host_window_x(sp: ShardedPanels, i: int, x):
    """Shard ``i``'s window of a FULL x, flat float32, on ``x``'s device:
    what the exchange delivers to that shard.  For tests and debugging (no
    communication)."""
    x = torch.as_tensor(x).to(torch.float32)
    if not sp.windowed:
        return x
    p = sp.p
    nloc = sp.shape[1] // p
    start = sp.local(i).win_start
    slabs = [((start + s) % p) * nloc for s in range(sp.win_slabs)]
    return torch.cat([x[a:a + nloc] for a in slabs])


def comms_bytes_per_iteration(A_panels: ShardedPanels,
                              itemsize: int = 4,
                              kdim: int = 0,
                              B_panels: ShardedPanels | None = None,
                              comm_itemsize: int | None = None) -> dict:
    """Analytic per-iteration communication volume (bytes per rank) of the
    sharded GMRES schedule of ``parallel/sharded_rows.py``, the JAX
    package's dict exactly.

    Per iteration: one x gather (windowed shifts or all_gather), two fused
    all_reduce(kdim+1) CGS2 reductions, ~4 scalar all_reduces (ring
    all-reduce ~= 2 (p-1)/p bytes/elem), and the back-projector's
    collective: a reduce_scatter of the n-vector in the transposed layout
    (``B_panels=None``), else a gather of the m-sharded intermediate
    through ``B_panels``'s own window.  ``comm_itemsize``: wire bytes per
    element of the gather terms under a narrower ``comm_dtype``."""
    p = A_panels.p
    n = A_panels.shape[1]
    nloc = n // p
    g_item = itemsize if comm_itemsize is None else comm_itemsize

    def _gather_bytes(sp: ShardedPanels) -> int:
        xloc = sp.shape[1] // p
        if sp.windowed:
            _, L = sp.shifts
            return L * xloc * g_item
        return (p - 1) * xloc * g_item

    gather = _gather_bytes(A_panels)
    if B_panels is None:
        b_collective = (p - 1) * nloc * itemsize
        b_key = "reduce_scatter_bytes"
    else:
        b_collective = _gather_bytes(B_panels)
        b_key = "b_gather_bytes"
    allred = 2.0 * (p - 1) / p * itemsize
    cgs2 = 2 * (kdim + 1) * allred
    scalars = 4 * allred
    return {
        "p": p,
        "gather_bytes": gather,
        b_key: b_collective,
        "cgs2_bytes": cgs2,
        "scalar_bytes": scalars,
        "total_bytes": gather + b_collective + cgs2 + scalars,
    }
