"""Bucketed block-ELL container and its host packer (PyTorch port).

Twin of ``hybrid_gmres_tpu/ops/sparse.py:BucketedBlockELL`` and
``bucketed_block_ell_from_csr``.  The packer is the same numpy code, so the
port's panels are byte-identical to the JAX package's (same buckets, same
``row_group`` padding and bucket cap, same ``inv_perm``).  ``row_group`` is
a packing argument only: the container keeps the padding it produced, and
the kernel never reads it.

Beside the per-bucket ``(blocks, bcols)`` the container holds the flat arrays
the CUDA kernel walks, built once at pack time:

  * ``blocks_flat`` (total_blocks, br, bc) and ``bcols_flat``
    (total_blocks,): every bucket's blocks concatenated.  The per-bucket
    ``buckets`` tensors are VIEWS into them, so the panel is stored once;
  * ``pos_off`` / ``pos_cnt`` (positions,): for each sorted block-row
    position, the offset of its first block in the flat arrays and its true
    block count (trailing bucket padding is skipped by the kernel);
  * ``pos_row`` (positions,): position -> original block-row, -1 for bucket
    padding positions (the JAX package keeps only its inverse ``inv_perm``).

and the block-column index the TRANSPOSED kernels walk (``y = A^T u`` from
this same panel), see :func:`_transposed_index`:

  * ``col_blk`` / ``col_row`` (live blocks,): every live block (a slot below
    its position's ``pos_cnt``, on a position that is not bucket padding)
    listed by block column, in ascending flat order inside a column: its
    index in ``blocks_flat`` and its original block-row;
  * ``seg_off`` (segments + 1,): the lists cut into segments of at most
    ``seg_len`` blocks that never span two block columns; one thread block
    of the kernel sums one segment;
  * ``col_seg`` (ncb + 1,): the segments of each block column, summed in
    this order by the kernel's finishing pass.

The index is a function of the panel alone, so the order of every sum in the
transposed products is fixed at pack time.

Beside the panel, :class:`RowPacked` is the compact row format of the
single-RHS products (``csrc/row_spmv.cu``), built by
:func:`row_packed_from_bell` from a panel's live blocks, so both forms hold
the same stored values: the nonzero entries only, in the panel's storage
type, with 16-bit column indices where the columns allow.
:class:`TilePacked` (:func:`tile_packed_from_bell`, from the same live
blocks) holds the same values as the nonempty dense 16 x 16 tiles of the
tensor-core product for wide right-hand-side blocks (``csrc/tile_spmm.cu``).

The JAX package's two portable reference formats have their twins here
too, on no kernel's path: :class:`ELLMatrix` (padded row-major ELL,
:func:`ell_from_csr`) and :class:`BlockELLMatrix` (padded BSR,
:func:`block_ell_from_csr`), each with a plain ``matvec``.

int4 panels (``packed4``): the JAX package stores two logical int4 blocks
in the nibbles of each int8 byte along the block axis.  The container
unpacks them on the host into logical int8 blocks in [-7, 7] and records
``packed4``; the block-ELL kernels run on that panel as int8.  The compact
storage lives in the row-packed form, which every product reads: two
entries a byte (:func:`pack_nibbles`).
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from hybrid_gmres_tpu_torch.utils.device import require_device


def pack_nibbles(vals):
    """int8 values in [-8, 7] (an even count) -> int8 bytes of two's
    complement nibble pairs: entry ``2i`` in the low nibble of byte ``i``,
    entry ``2i + 1`` in its high nibble.  A zero entry is a zero nibble."""
    pairs = vals.to(torch.int32).reshape(-1, 2) & 15
    return (pairs[:, 0] | (pairs[:, 1] << 4)).to(torch.uint8).view(torch.int8)


def unpack_nibbles(packed):
    """The inverse of :func:`pack_nibbles`, with the JAX kernels' shifts
    (``ops/spmv_pallas.py``): int8 values, two per byte, low nibble
    first."""
    raw = packed.to(torch.int32)
    lo = (raw << 28) >> 28
    hi = (raw << 24) >> 28
    return torch.stack([lo, hi], dim=-1).reshape(
        *packed.shape[:-1], 2 * packed.shape[-1]).to(torch.int8)


def _unpack_blocks(blocks):
    """A JAX ``packed4`` bucket (nbr_b, maxb_pk, br, bc) of nibble bytes ->
    its logical int8 blocks (nbr_b, 2 maxb_pk, br, bc): byte j of a
    block-row holds logical block 2j (low nibble) and 2j + 1 (high)."""
    raw = torch.tensor(np.asarray(blocks).view(np.int8))
    return unpack_nibbles(raw.movedim(1, -1)).movedim(-1, 1).numpy()


@dataclass
class BucketedBlockELL:
    """Sliced block-ELL: block-rows sorted by block count and partitioned
    into buckets, each padded only to its own max count.

    ``inv_perm[orig_block_row] = position in the sorted/concatenated order``.
    Build with :func:`bucketed_block_ell_from_csr` or :meth:`from_numpy`.
    The plain products are ``ops.spmv_cuda.bucket_matvec_plain`` and
    ``bucket_matmat_plain``.
    """

    buckets: tuple            # of (blocks (nbr_b, maxb_b, BR, BC), bcols (nbr_b, maxb_b))
    inv_perm: torch.Tensor    # (nbr_total,) int64
    shape: tuple              # logical (m, n)
    ncb: int                  # number of block columns (padded)
    blocks_flat: torch.Tensor  # (total_blocks, BR, BC)
    bcols_flat: torch.Tensor   # (total_blocks,) int32
    pos_off: torch.Tensor      # (positions,) int64
    pos_cnt: torch.Tensor      # (positions,) int32
    pos_row: torch.Tensor      # (positions,) int32, -1 on padding positions
    col_blk: torch.Tensor      # (live,) int32: flat block index, by column
    col_row: torch.Tensor      # (live,) int32: its original block-row
    seg_off: torch.Tensor      # (segments + 1,) int32 into col_blk/col_row
    col_seg: torch.Tensor      # (ncb + 1,) int32 into seg_off
    seg_len: int               # most blocks in one segment
    packed4: bool = False      # int4 values (held as int8 in [-7, 7])

    @classmethod
    def from_numpy(cls, buckets, inv_perm, shape, ncb, packed4=False,
                   device="cuda", dtype=None):
        """Container from numpy per-bucket ``(blocks, bcols)`` arrays.

        ``device``: where the panel lives; the default is the card, and it
        raises without one (pass ``"cpu"`` for the CPU path).
        ``dtype``: torch storage dtype (default: the blocks' own; bfloat16
        arrays from ``ml_dtypes`` are reinterpreted bit for bit).
        ``packed4=True``: the JAX package's int4 layout (nibble-pair bytes
        along the block axis, one ``bcols`` entry per logical block), which
        is unpacked here into logical int8 blocks.
        """
        if packed4:
            buckets = [(_unpack_blocks(b), c) for b, c in buckets]
        return cls._from_logical(buckets, inv_perm, shape, ncb, packed4,
                                 device, dtype)

    @classmethod
    def _from_logical(cls, buckets, inv_perm, shape, ncb, packed4, device,
                      dtype):
        """Container from logical (unpacked) per-bucket numpy arrays."""
        device = require_device(device)
        br, bc = buckets[0][0].shape[2:]
        flat_b, flat_c, offs, cnts = [], [], [], []
        base = 0
        for blocks, bcols in buckets:
            nbr_b, maxb_b = bcols.shape
            flat_b.append(np.ascontiguousarray(blocks).reshape(-1, br, bc))
            flat_c.append(np.asarray(bcols, np.int32).reshape(-1))
            offs.append(base + np.arange(nbr_b, dtype=np.int64) * maxb_b)
            cnts.append(_slot_counts(blocks, bcols))
            base += nbr_b * maxb_b
        blocks_flat = _to_torch(np.concatenate(flat_b), device, dtype)
        bcols_np, off_np, cnt_np = (np.concatenate(flat_c),
                                    np.concatenate(offs),
                                    np.concatenate(cnts))
        bcols_flat = torch.as_tensor(bcols_np, device=device)
        views, start = [], 0
        for blocks, bcols in buckets:
            nbr_b, maxb_b = bcols.shape
            stop = start + nbr_b * maxb_b
            views.append((blocks_flat[start:stop].view(nbr_b, maxb_b, br, bc),
                          bcols_flat[start:stop].view(nbr_b, maxb_b)))
            start = stop
        inv_perm = np.asarray(inv_perm, np.int64)
        n_pos = sum(int(c.shape[0]) for _, c in buckets)
        pos_row = np.full(n_pos, -1, np.int32)
        pos_row[inv_perm] = np.arange(len(inv_perm), dtype=np.int32)
        col_blk, col_row, seg_off, col_seg, seg_len = _transposed_index(
            bcols_np, off_np, cnt_np, pos_row, int(ncb))
        return cls(
            buckets=tuple(views),
            inv_perm=torch.as_tensor(inv_perm, device=device),
            shape=(int(shape[0]), int(shape[1])),
            ncb=int(ncb),
            blocks_flat=blocks_flat,
            bcols_flat=bcols_flat,
            pos_off=torch.as_tensor(off_np, device=device),
            pos_cnt=torch.as_tensor(cnt_np, device=device),
            pos_row=torch.as_tensor(pos_row, device=device),
            col_blk=torch.as_tensor(col_blk, device=device),
            col_row=torch.as_tensor(col_row, device=device),
            seg_off=torch.as_tensor(seg_off, device=device),
            col_seg=torch.as_tensor(col_seg, device=device),
            seg_len=seg_len,
            packed4=bool(packed4),
        )

    @property
    def block_shape(self):
        return tuple(self.blocks_flat.shape[1:])

    @property
    def dtype(self):
        return self.blocks_flat.dtype

    @property
    def device(self):
        return self.blocks_flat.device

    @property
    def nbytes(self):
        return self.blocks_flat.numel() * self.blocks_flat.element_size()

    def matvec(self, x):
        """Plain PyTorch ``y = A x`` (the JAX reference ``matvec``): see
        ``ops.spmv_cuda.bucket_matvec_plain``."""
        from hybrid_gmres_tpu_torch.ops.spmv_cuda import bucket_matvec_plain

        return bucket_matvec_plain(self, x)

    def to(self, device) -> "BucketedBlockELL":
        """The same panel on ``device`` (itself if it is there already):
        every tensor copied, the bucket views re-cut from the copies."""
        device = torch.device(device)
        if device == self.device:
            return self
        moved = {f.name: getattr(self, f.name).to(device)
                 for f in dataclasses.fields(self)
                 if isinstance(getattr(self, f.name), torch.Tensor)}
        views, start = [], 0
        for blocks, bcols in self.buckets:
            stop = start + bcols.numel()
            views.append((moved["blocks_flat"][start:stop].view(blocks.shape),
                          moved["bcols_flat"][start:stop].view(bcols.shape)))
            start = stop
        return dataclasses.replace(self, buckets=tuple(views), **moved)


def _slot_counts(blocks, bcols):
    """True block count of each block-row of one bucket: the trip count of
    the kernel's block loop.

    Rows are packed with ascending block columns and padded with (bcol 0,
    zero block), so the count is one past the last nonzero bcol; a row whose
    only block sits in column 0 counts it when that block is nonzero.  An
    all-zero block in column 0 (possible after int8 rounding) is dropped,
    which changes nothing: it adds zero.
    """
    bcols = np.asarray(bcols)
    nbr_b, maxb_b = bcols.shape
    nz = bcols != 0
    last = np.where(nz.any(axis=1), maxb_b - np.argmax(nz[:, ::-1], axis=1), 0)
    first = np.asarray(blocks)[:, 0].reshape(nbr_b, -1)
    first_live = (first != 0).any(axis=1)
    return np.where(last > 0, last, first_live.astype(np.int64)).astype(
        np.int32)


# The transposed kernels run one thread block per segment: enough segments
# to fill the card's 132 multiprocessors several times over on the small
# panel, and short enough that the staged ``u`` values of one segment fit in
# shared memory at 8 right-hand sides (32 blocks x 32 rows x 8 x 4 bytes).
SEG_TARGET = 1024
SEG_MAX = 32


def _transposed_index(bcols_flat, pos_off, pos_cnt, pos_row, ncb):
    """The pack-time block-column index of a panel (numpy in, numpy out).

    Returns ``(col_blk, col_row, seg_off, col_seg, seg_len)``: the live
    blocks sorted by block column (stable, so ascending flat index inside a
    column), the original block-row of each, the segment boundaries and the
    segments of each column.  Bucket padding positions and the padded slots
    past ``pos_cnt`` are not listed: they hold zero blocks.
    """
    live_pos = np.nonzero((pos_row >= 0) & (pos_cnt > 0))[0]
    cnt = pos_cnt[live_pos].astype(np.int64)
    total = int(cnt.sum())
    start = np.concatenate([[0], np.cumsum(cnt)[:-1]]) if len(cnt) else cnt
    flat = np.repeat(pos_off[live_pos], cnt) + (
        np.arange(total) - np.repeat(start, cnt))
    rows = np.repeat(pos_row[live_pos], cnt)
    cols = bcols_flat[flat]
    order = np.argsort(cols, kind="stable")
    per_col = np.bincount(cols, minlength=ncb).astype(np.int64)
    seg_len = int(min(SEG_MAX, max(1, -(-total // SEG_TARGET))))
    nseg = -(-per_col // seg_len)
    col_seg = np.concatenate([[0], np.cumsum(nseg)])
    col_start = np.concatenate([[0], np.cumsum(per_col)[:-1]])
    seg_col = np.repeat(np.arange(ncb), nseg)
    seg_off = col_start[seg_col] + (
        np.arange(int(col_seg[-1])) - col_seg[seg_col]) * seg_len
    seg_off = np.concatenate([seg_off, [total]])
    i32 = np.int32
    return (flat[order].astype(i32), rows[order].astype(i32),
            seg_off.astype(i32), col_seg.astype(i32), seg_len)


# The row-packed form.  A row is cut into vectors of VEC entries (one load
# of values, one or two 16-byte loads of indices) and padded to whole
# vectors.  Each row is summed by a group of ``lanes`` threads, chosen per
# form so that an average row gives each lane VECS_PER_LANE vectors; a row
# takes at most one thread block of the kernel (MAX_LANES threads).  Rows are
# sorted by length, longest first, inside windows of SIGMA rows (SELL-C-sigma
# style): neighbouring rows stay neighbours, and the rows that share a warp
# have about the same length.
VEC = 8
VECS_PER_LANE = 2
MAX_LANES = 256
SIGMA = 256
U16_COLS = 65536      # most columns a 16-bit index can address


@dataclass
class RowPacked:
    """A sparse matrix as padded, interleaved rows: the format of the
    redesigned K1/K3 (``csrc/row_spmv.cu``).

    Each row's entries have a pack order: the order of the source panel's
    blocks (the panel's flat order for the transpose of a panel, ascending
    block column otherwise), then ascending position inside the block; in
    the forward form of a panel that is ascending column order.  Runs of
    entries from one source block are the row's segments: they share
    ``col // group`` (``group``: the blocks' extent along this form's
    columns).

    Packed row ``r`` (original row ``row_map[r]``) owns vectors
    ``vec_off[r] .. vec_off[r + 1] - 1``; vector ``k`` holds entries
    ``vals[k * VEC : (k + 1) * VEC]`` and their columns.  Lane ``l`` of the
    row's group of ``lanes`` threads sums vectors ``l, l + lanes, ...`` of
    the row.  Inside one step of the group (``r_t`` vectors, ``r_t`` =
    ``lanes`` but on the last step), slot ``j`` of the step's ``l``-th
    vector holds the row's entry ``t * lanes * VEC + j * r_t + l`` in pack
    order (:func:`pack_positions`), so the lanes of a step gather
    neighbouring entries together.  Padding entries close the pack order:
    zero, in the row's last column (a column the row reads anyway).

    ``cols`` is int16 holding unsigned 16-bit indices when the matrix has at
    most 65536 columns (read it with ``& 0xFFFF``), int32 otherwise.  Build
    with :func:`row_packed_from_bell`; the products are
    ``ops.spmv_cuda.row_matvec`` / ``row_rmatvec``.

    ``packed4``: the form of an int4 panel.  ``vals`` then holds the values
    as nibble pairs (:func:`pack_nibbles`), a vector of VEC entries in
    VEC / 2 bytes (slot ``2i`` in the low nibble of byte ``i``, ``2i + 1``
    in the high one); the pack order, the lanes and the padding (a zero
    nibble) are those of the int8 form of the same panel.
    """

    vals: torch.Tensor      # (vectors * VEC,) storage dtype; int4: / 2 bytes
    cols: torch.Tensor      # (vectors * VEC,) int16 (uint16 bits) or int32
    vec_off: torch.Tensor   # (rows + 1,) int32: first vector of each row
    row_map: torch.Tensor   # (rows,) int32: packed row -> original row
    shape: tuple            # (rows, columns) of the matrix this form holds
    lanes: int              # threads per row, a power of two
    live: int               # stored nonzeros; the rest is padding
    group: int              # source blocks' extent along the columns
    packed4: bool = False   # values as int4 nibble pairs
    # the window form of the window kernel (:class:`RowWindows`), made with
    # the form on the card (:meth:`__post_init__`); None on the CPU
    wins: object = dataclasses.field(default=None, init=False, repr=False,
                                     compare=False)

    def __post_init__(self):
        """A form made on, or moved to, the card gets its window form here,
        so no product builds one (:func:`kept_windows`)."""
        if self.vals.is_cuda:
            self.wins = kept_windows(self)

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def value_bits(self):
        """Bits of one stored value: 4 for an int4 form."""
        return 4 if self.packed4 else 8 * self.vals.element_size()

    def entry_values(self):
        """The stored values, one per entry (int4 forms decoded to int8)."""
        return unpack_nibbles(self.vals) if self.packed4 else self.vals

    def to(self, device) -> "RowPacked":
        """The same form on ``device`` (itself if it is there already; on
        the card with its window form made there)."""
        device = torch.device(device)
        if device == self.device:
            return self
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device)
                     for f in ("vals", "cols", "vec_off", "row_map")})

    @property
    def device(self):
        return self.vals.device

    @property
    def wide(self):
        """True when the column indices are 32-bit."""
        return self.cols.dtype == torch.int32

    @property
    def fill(self):
        """Share of the stored entries that are nonzeros, not padding."""
        return self.live / max(self.cols.numel(), 1)

    @property
    def nbytes(self):
        return sum(t.numel() * t.element_size() for t in
                   (self.vals, self.cols, self.vec_off, self.row_map))

    def col_index(self):
        """The column indices as int64 (for the plain version)."""
        c = self.cols.to(torch.int64)
        return c if self.wide else c & 0xFFFF

    @cached_property
    def sum_order(self):
        """The order of the plain version's fixed-order sum, worked out on
        first use and kept: ``(src, cols, seg_steps, row_steps, rows)``.
        ``src`` and ``cols`` (int64) list every stored entry in pack order,
        row after row.  The segments (runs of one row's entries from one
        source block) are chained rank by rank: step ``i`` of ``seg_steps``
        is ``(entries, their segments)`` for the entries of rank ``i``.
        ``row_steps`` then adds each row's segments in order the same way,
        into the rows ``rows`` (packed rows that hold entries)."""
        vec_row, p = pack_positions(self.vec_off, self.lanes)
        pack = (self.vec_off[vec_row].long()[:, None] * VEC + p).reshape(-1)
        src = torch.empty_like(pack)
        src[pack] = torch.arange(pack.shape[0], device=pack.device)
        cols = self.col_index()[src]
        row_of = vec_row.repeat_interleave(VEC)[src]
        row_start = torch.ones_like(row_of, dtype=torch.bool)
        row_start[1:] = row_of[1:] != row_of[:-1]
        seg_start = row_start.clone()
        block = cols // self.group
        seg_start[1:] |= block[1:] != block[:-1]
        return (src, cols, _rank_steps(seg_start),
                _rank_steps(row_start[seg_start]), row_of[row_start])


def _rank_steps(starts):
    """Runs of consecutive items (a run begins where ``starts`` is True),
    item by rank inside the runs: ``[(items, their runs), ...]``, one pair
    per rank."""
    pos = torch.arange(starts.shape[0], device=starts.device)
    run = torch.cumsum(starts, 0) - 1
    rank = pos - pos[starts][run]
    order = torch.argsort(rank, stable=True)
    steps = []
    for idx in torch.split(order, torch.bincount(rank).tolist()):
        steps.append((idx, run[idx]))
    return steps


def _lanes_for(lengths):
    mean = float(lengths.mean()) if len(lengths) else 0.0
    want = max(1, int(np.ceil(mean / (VEC * VECS_PER_LANE))))
    return min(MAX_LANES, 1 << (want - 1).bit_length())


def pack_positions(vec_off, lanes):
    """The interleaving of a form with row offsets ``vec_off`` (in vectors)
    and ``lanes`` lanes per row: for every stored entry (shape (vectors,
    VEC)), its packed row and its position in that row's pack order.  Lane
    ``l`` of step ``t`` of a row (``r_t`` vectors in the step) holds entry
    ``t * lanes * VEC + j * r_t + l`` in its slot ``j``."""
    nv = (vec_off[1:] - vec_off[:-1]).long()
    vec_row = torch.repeat_interleave(
        torch.arange(nv.shape[0], device=nv.device), nv)
    k = torch.arange(int(vec_off[-1]), device=nv.device) - \
        vec_off[vec_row].long()
    t, lane = k // lanes, k % lanes
    r_t = torch.clamp(nv[vec_row] - t * lanes, max=lanes)
    p = (t * lanes * VEC + lane)[:, None] + \
        torch.arange(VEC, device=nv.device) * r_t[:, None]
    return vec_row, p


def _pack_rows(row, key, col, vals, nrows, ncols, group, device,
               packed4=False):
    """The row-packed form of the entries ``(row[i], col[i], vals[i])``
    (numpy int64 rows, pack-order keys and columns, a 1-D torch tensor of
    values, each (row, column) at most once); each row's pack order is
    ascending ``key``.  ``packed4``: int8 values in [-8, 7], stored as
    nibble pairs."""
    order = np.argsort(row * (int(key.max(initial=0)) + 1) + key,
                       kind="stable")
    row, col = row[order], col[order]
    vals = vals[torch.from_numpy(order)]
    lens = np.bincount(row, minlength=nrows).astype(np.int64)
    start = np.cumsum(lens) - lens
    row_map = np.lexsort((-lens, np.arange(nrows) // SIGMA))
    plen = lens[row_map]
    nv = -(-plen // VEC)
    vec_off = np.concatenate([[0], np.cumsum(nv)]).astype(np.int64)
    if vec_off[-1] >= 2 ** 31:
        raise ValueError("row-packed form: more than 2^31 vectors")
    lanes = _lanes_for(plen)
    vec_row, p = (a.numpy() for a in pack_positions(
        torch.from_numpy(vec_off), lanes))
    plen_v = plen[vec_row][:, None]
    live = p < plen_v
    src = (start[row_map[vec_row]][:, None]
           + np.minimum(p, plen_v - 1)).reshape(-1)
    live = torch.from_numpy(live.reshape(-1))
    packed_vals = torch.where(live, vals[torch.from_numpy(src)],
                              torch.zeros((), dtype=vals.dtype))
    cols = col[src]
    cols = (cols.astype(np.uint16).view(np.int16) if ncols <= U16_COLS
            else cols.astype(np.int32))
    if packed4:
        packed_vals = pack_nibbles(packed_vals)
    return RowPacked(
        vals=packed_vals.to(device),
        cols=torch.from_numpy(cols).to(device),
        vec_off=torch.from_numpy(vec_off.astype(np.int32)).to(device),
        row_map=torch.from_numpy(row_map.astype(np.int32)).to(device),
        shape=(int(nrows), int(ncols)), lanes=lanes, live=int(len(row)),
        group=int(group), packed4=bool(packed4))


def _live_entries(bell: BucketedBlockELL):
    """The nonzero entries of a panel's live blocks (the slots below each
    position's ``pos_cnt`` on positions that are not bucket padding), in
    the panel's flat order: ``(row, col, vals, key_t)`` with numpy int64
    rows and columns, the values in the panel's storage type (a 1-D torch
    tensor on the host) and ``key_t``, each entry's place in the panel's
    flat block order (the pack order of the transpose)."""
    br, bc = bell.block_shape
    m, n = bell.shape
    pos_off = bell.pos_off.cpu().numpy()
    pos_cnt = bell.pos_cnt.cpu().numpy().astype(np.int64)
    pos_row = bell.pos_row.cpu().numpy()
    bcols = bell.bcols_flat.cpu().numpy().astype(np.int64)
    live_pos = np.nonzero((pos_row >= 0) & (pos_cnt > 0))[0]
    cnt = pos_cnt[live_pos]
    first = np.cumsum(cnt) - cnt
    slots = np.repeat(pos_off[live_pos], cnt) + (
        np.arange(int(cnt.sum())) - np.repeat(first, cnt))
    slot_row = np.full(bell.blocks_flat.shape[0], -1, np.int64)
    slot_row[slots] = np.repeat(pos_row[live_pos], cnt)
    blocks = bell.blocks_flat.cpu()
    nz = (blocks != 0).numpy() & (slot_row >= 0)[:, None, None]
    flat = np.flatnonzero(nz)
    b, rc = np.divmod(flat, br * bc)
    r, c = np.divmod(rc, bc)
    row = slot_row[b] * br + r
    col = bcols[b] * bc + c
    keep = (row < m) & (col < n)
    vals = blocks.reshape(-1)[torch.from_numpy(flat[keep])]
    if bell.packed4 and len(vals) and not bool(
            ((vals >= -8) & (vals <= 7)).all()):
        raise ValueError("an int4 panel holds values outside [-8, 7]")
    return row[keep], col[keep], vals, b[keep] * br + r[keep]


def row_packed_from_bell(bell: BucketedBlockELL,
                         transpose: bool = False) -> RowPacked:
    """The row-packed form of a panel (``transpose=True``: of its
    transpose), built from its live blocks: the slots below each position's
    ``pos_cnt`` on positions that are not bucket padding.  Entries that are
    exactly zero are dropped; the values keep the panel's storage type, so
    the form holds the panel's matrix exactly (an int4 panel's as nibble
    pairs).  Each row's pack order follows the panel's blocks (see
    :class:`RowPacked`).  Lives on the panel's device."""
    br, bc = bell.block_shape
    m, n = bell.shape
    row, col, vals, key_t = _live_entries(bell)
    if transpose:   # a column's entries by the panel's flat block order
        return _pack_rows(col, key_t, row, vals, n, m, br, bell.device,
                          bell.packed4)
    return _pack_rows(row, col, col, vals, m, n, bc, bell.device,
                      bell.packed4)


# The window form: what the window kernel (csrc/row_spmv.cu,
# row_spmm_window) reads beside a row-packed form.  A thread block of
# WINDOW_THREADS threads holds WINDOW_THREADS / lanes consecutive packed rows,
# a window; it copies the distinct columns of X that the window reads into
# shared memory once (8 floats a column, two buffers, one per window in
# flight), and its lanes gather from there.  WINDOW_MAX_COLS is the most
# columns one buffer holds: 2 x 32 bytes x 3584 = 224 KB of the 227 KB a
# block may have (WNT and WIN_COLS in the kernel).  The staging pays for
# itself with the reads of the staged columns: a form keeps its window form
# where the windows read each listed column at least WINDOW_MIN_REUSE times
# (stored slots per listed column).  Measured on CT n=64 and n=128, A, B
# and their transposes, four storage types, at R=8 (chip_smoke.py's
# window_kernels, PERF.md section 6): faster than the gathers on every form
# of reuse 4.3 or more (the ray-row forms, 10-22; at n=64 the pixel-row
# forms too, 4.3-6.2), slower on n=128's pixel-row forms (reuse 3.3-3.9).
WINDOW_THREADS = 1024
WINDOW_MAX_COLS = 3584
WINDOW_MIN_REUSE = 4.0


@dataclass
class RowWindows:
    """The windows of a row-packed form (:func:`row_windows_from`).

    The packed rows are taken in the order of the rows they hold
    (``rows``: the packed row at each place, by ``row_map``): the rows of
    the source matrix in order, rays or pixels in Morton order, whose
    neighbours read neighbouring columns.  (The packed order sorts rows by
    length inside windows of SIGMA, which scatters neighbours wherever
    lengths differ by an entry.)  Window ``w`` holds the packed rows at
    places ``win_row[w] .. win_row[w + 1] - 1`` (at most
    ``rows_per_window``, the rows one thread block holds; fewer where a
    whole block's rows read more than ``WINDOW_MAX_COLS`` columns) and reads
    the columns ``wcols[win_off[w] : win_off[w + 1]]``, distinct and
    ascending.  ``local`` has one entry per stored slot of the row form (the
    same layout as its ``cols``): the slot's position in its window's list,
    16 bits (int16 holding unsigned values), so
    ``wcols[win_off[w] + local] == cols`` on every slot, padding included.
    The values, offsets, row map and lanes are the row form's own."""

    local: torch.Tensor     # (vectors * VEC,) int16 (uint16 bits)
    wcols: torch.Tensor     # (listed columns,) int32
    win_off: torch.Tensor   # (windows + 1,) int32: each window's list
    win_row: torch.Tensor   # (windows + 1,) int32: each window's places
    rows: torch.Tensor      # (rows,) int32: the packed row at each place
    rows_per_window: int    # rows of a full window
    max_cols: int           # the longest list
    reuse: float            # stored slots of the form per listed column
    seconds: float          # the build's wall time

    @property
    def windows(self):
        return self.win_off.shape[0] - 1

    @property
    def listed(self):
        """Columns staged over all windows: one tile of a product copies
        this many columns of X into shared memory."""
        return self.wcols.shape[0]

    @property
    def nbytes(self):
        return sum(t.numel() * t.element_size() for t in
                   (self.local, self.wcols, self.win_off, self.win_row,
                    self.rows))

    def slot_windows(self, rp: RowPacked):
        """The window of every stored slot of ``rp`` (int64)."""
        nv = (rp.vec_off[1:] - rp.vec_off[:-1]).long()
        wr = (self.win_row[1:] - self.win_row[:-1]).long()
        win_of_place = torch.repeat_interleave(
            torch.arange(wr.shape[0], device=wr.device), wr)
        win_of_row = torch.empty_like(win_of_place)
        win_of_row[self.rows.long()] = win_of_place
        return torch.repeat_interleave(win_of_row, nv).repeat_interleave(VEC)

    def slot_cols(self, rp: RowPacked):
        """The column of every stored slot of ``rp``, read through its
        window's list (int64): ``rp.col_index()`` when the form is right."""
        start = self.win_off.long()[self.slot_windows(rp)]
        return self.wcols.long()[start + (self.local.long() & 0xFFFF)]


def row_windows_from(rp: RowPacked):
    """The window form of ``rp`` for thread blocks of WINDOW_THREADS, built
    with torch ops on the form's device.  The packed rows are placed in the
    order of the rows they hold; a block of ``WINDOW_THREADS // lanes``
    consecutive places is one window when its rows read at most
    WINDOW_MAX_COLS distinct columns; otherwise it is cut into equal
    windows of half, a quarter, ... of its places, the first cut at which
    each fits.  Returns None when a single row reads more than
    WINDOW_MAX_COLS columns."""
    t0 = time.perf_counter()
    max_cols = WINDOW_MAX_COLS
    if max_cols > U16_COLS:
        raise ValueError("window form: local indices are 16-bit")
    rows, ncols = rp.shape
    dev = rp.device
    W = max(WINDOW_THREADS // rp.lanes, 1)
    nv = (rp.vec_off[1:] - rp.vec_off[:-1]).long()
    order = torch.argsort(rp.row_map.long())       # place -> packed row
    place = torch.empty_like(order)
    place[order] = torch.arange(rows, device=dev)
    # each vector's place (the windows below are over places)
    vec_place = place[torch.repeat_interleave(torch.arange(rows, device=dev),
                                            nv)]
    cols = rp.col_index().view(-1, VEC)
    nblk = -(-rows // W)
    size = torch.zeros(nblk, dtype=torch.long, device=dev)
    pending = torch.ones(nblk, dtype=torch.bool, device=dev)
    s = W
    while True:   # the places of each block's windows: W, W / 2, ...
        sel = pending[vec_place // W]
        key = (vec_place[sel] // s)[:, None] * ncols + cols[sel]
        nsub = -(-rows // s)
        count = torch.bincount(torch.unique(key) // ncols, minlength=nsub)
        count = torch.nn.functional.pad(count, (0, nblk * (W // s) - nsub))
        fits = pending & (count.view(nblk, W // s).amax(1) <= max_cols)
        size[fits] = s
        pending &= ~fits
        if not bool(pending.any()):
            break
        if s == 1:
            return None
        s //= 2
    first = torch.arange(nblk, device=dev) * W
    nwin = -(-torch.clamp(rows - first, max=W) // size)
    win0 = torch.cumsum(nwin, 0) - nwin
    p = torch.arange(rows, device=dev)
    b = p // W
    win_of_place = win0[b] + (p - first[b]) // size[b]
    total = int(nwin.sum())
    win_row = torch.full((total + 1,), rows, dtype=torch.long, device=dev)
    starts = (p - first[b]) % size[b] == 0
    win_row[win_of_place[starts]] = p[starts]
    slot_win = win_of_place[vec_place]
    key = (slot_win[:, None] * ncols + cols).reshape(-1)
    uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
    count = torch.bincount(uniq // ncols, minlength=total)
    win_off = torch.zeros(total + 1, dtype=torch.long, device=dev)
    win_off[1:] = torch.cumsum(count, 0)
    local = inv - win_off[slot_win].repeat_interleave(VEC)
    i32 = torch.int32
    out = RowWindows(
        local=local.to(i32).to(torch.int16), wcols=(uniq % ncols).to(i32),
        win_off=win_off.to(i32), win_row=win_row.to(i32), rows=order.to(i32),
        rows_per_window=W, max_cols=int(count.max()) if total else 0,
        reuse=rp.cols.numel() / max(uniq.shape[0], 1), seconds=0.0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out.seconds = time.perf_counter() - t0
    return out


def kept_windows(rp: RowPacked):
    """The window form of ``rp`` (:func:`row_windows_from`) where its
    windows read each listed column at least WINDOW_MIN_REUSE times, else
    None: what a form on the card keeps."""
    wf = row_windows_from(rp)
    return wf if wf is not None and wf.reuse >= WINDOW_MIN_REUSE else None


# The tile form: the matrix as dense TILE x TILE tiles, the A operands of
# the tensor cores' mma.m16n8k16 (csrc/tile_spmm.cu).  Rows are cut into
# panels of PANEL_ROWS (four row groups of TILE rows, one warp each) in the
# operator's own row order, columns into chunks of TILE.
TILE = 16
PANEL_ROWS = 64
ROW_GROUPS = PANEL_ROWS // TILE
# One 16-byte load a lane fetches a warp's fragments of this many tiles of
# its row group, by the bits of a value: 8 bytes a lane per int8 tile, 4 per
# int4 tile.  A group of tiles takes 512 bytes whatever the type.  bf16 and
# float32 values are not integers: no tile form (their products keep the
# row-packed form).
TILES_PER_LOAD = {8: 2, 4: 4}


def _fragment_slots():
    """(lane, slot) of entry (r, k) of a tile in the s8 A fragment of
    mma.m16n8k16, ``g = r % 8``: lane 4 g + k // 4, slots 0-3 row g, k 4
    (lane % 4) .. + 3; slots 4-7 row g + 8."""
    r, k = np.divmod(np.arange(TILE * TILE), TILE)
    return (r % 8) * 4 + k // 4, (r // 8) * 4 + k % 4


# (lane, slot) of every tile entry
FRAG = _fragment_slots()


@dataclass
class TilePacked:
    """A sparse matrix as its nonempty dense tiles: the format of K2 for
    wide right-hand-side blocks (K2w, ``csrc/tile_spmm.cu``).

    Panel ``p`` holds rows ``PANEL_ROWS p ..``; its entries
    ``panel_off[p] .. panel_off[p + 1] - 1`` are its nonempty column chunks
    in ascending order, each ``ent[e] = chunk << 4 | mask``, bit ``w`` of
    the mask set when row group ``w`` of the panel has a nonzero in the
    chunk.  The tiles of row group ``g`` (``ROW_GROUPS p + w``) follow each
    other in chunk order from tile ``rg_off[g]`` on (a multiple of the
    tiles one load fetches, ``tiles_per_load``; the run is padded with zero
    tiles to the next one).

    ``vals`` holds the tiles in groups of ``tiles_per_load``, 512 bytes a
    group: lane ``l``'s 16 bytes of a group hold its A fragment of each
    tile of the group in turn, 8 entries in slot order (``FRAG``: s8
    fragments); int4 values as nibble pairs (slot ``2i`` in the low nibble
    of byte ``i``).  Int8 and int4 values only.  Build with
    :func:`tile_packed_from_bell`; the product is
    ``ops.spmv_cuda.wide_matmat``."""

    vals: torch.Tensor       # (groups * 512 bytes,) storage dtype
    ent: torch.Tensor        # (entries,) int32: chunk << 4 | row-group mask
    panel_off: torch.Tensor  # (panels + 1,) int32
    rg_off: torch.Tensor     # (ROW_GROUPS * panels + 1,) int32, in tiles
    shape: tuple             # (rows, columns)
    live: int                # stored nonzeros
    tiles: int               # nonempty tiles (the padding tiles not counted)
    packed4: bool = False    # values as int4 nibble pairs

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self):
        return self.vals.device

    @property
    def value_bits(self):
        return 4 if self.packed4 else 8 * self.vals.element_size()

    @property
    def tiles_per_load(self):
        return TILES_PER_LOAD[self.value_bits]

    @property
    def panels(self):
        return self.panel_off.shape[0] - 1

    @property
    def chunks(self):
        return -(-self.shape[1] // TILE)

    @property
    def fill(self):
        """Share of the nonempty tiles' entries that are nonzeros."""
        return self.live / max(self.tiles * TILE * TILE, 1)

    @property
    def nbytes(self):
        return sum(t.numel() * t.element_size() for t in
                   (self.vals, self.ent, self.panel_off, self.rg_off))

    def to(self, device) -> "TilePacked":
        """The same form on ``device`` (itself if it is there already)."""
        device = torch.device(device)
        if device == self.device:
            return self
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device)
                     for f in ("vals", "ent", "panel_off", "rg_off")})

    def tile_index(self):
        """``(pos, chunk, group)`` of every nonempty tile (int64): its place
        in ``vals`` (in tiles), its column chunk and its row group."""
        ent = self.ent.long()
        counts = (self.panel_off[1:] - self.panel_off[:-1]).long()
        panel = torch.repeat_interleave(
            torch.arange(self.panels, device=ent.device), counts)
        first = (self.panel_off[:-1].long())[panel]
        out = []
        for w in range(ROW_GROUPS):
            e = torch.nonzero((ent >> w) & 1).reshape(-1)
            # rank of entry e among its panel's entries with bit w set
            start = torch.searchsorted(e, first[e])
            rank = torch.arange(e.shape[0], device=ent.device) - start
            group = ROW_GROUPS * panel[e] + w
            out.append((self.rg_off.long()[group] + rank, ent[e] >> 4,
                        group))
        return tuple(torch.cat(parts) for parts in zip(*out))

    def tile_values(self):
        """Every tile slot of ``vals`` as a dense (slots, TILE, TILE)
        tensor of the storage values (int4 decoded to int8), padding tiles
        included."""
        g = self.tiles_per_load
        v = unpack_nibbles(self.vals) if self.packed4 else self.vals
        frag = v.reshape(-1, 32, g, 8).transpose(1, 2).reshape(-1, 32 * 8)
        lane, slot = FRAG
        idx = torch.from_numpy(lane * 8 + slot).to(frag.device)
        return frag[:, idx].reshape(-1, TILE, TILE)


def tile_packed_from_bell(bell: BucketedBlockELL) -> TilePacked:
    """The tile form of a panel's matrix, built on the host from the live
    blocks that :func:`row_packed_from_bell` reads, so both forms hold the
    same stored values.  Lives on the panel's device."""
    m, n = bell.shape
    bits = 4 if bell.packed4 else 8 * bell.blocks_flat.element_size()
    if bits not in TILES_PER_LOAD:
        raise TypeError(f"tile form: no tiles of {bell.dtype} values")
    g = TILES_PER_LOAD[bits]
    row, col, vals, _ = _live_entries(bell)
    panels = -(-m // PANEL_ROWS)
    nchunks = -(-n // TILE)
    group, chunk = row // TILE, col // TILE
    tile_key, tile_of = np.unique(group * nchunks + chunk,
                                  return_inverse=True)
    t_group, t_chunk = np.divmod(tile_key, nchunks)
    per_group = np.bincount(t_group, minlength=panels * ROW_GROUPS)
    padded = -(-per_group // g) * g
    rg_off = np.concatenate([[0], np.cumsum(padded)]).astype(np.int64)
    if rg_off[-1] >= 2 ** 31:
        raise ValueError("tile form: more than 2^31 tiles")
    rank = np.arange(len(tile_key)) - (np.cumsum(per_group) - per_group)[
        t_group]
    pos = rg_off[t_group] + rank
    # the panels' entries: their nonempty chunks, with the row-group masks
    pkey = (t_group // ROW_GROUPS) * nchunks + t_chunk
    ent_key, ent_of = np.unique(pkey, return_inverse=True)
    mask = np.zeros(len(ent_key), np.int64)
    np.bitwise_or.at(mask, ent_of, 1 << (t_group % ROW_GROUPS))
    ent_panel, ent_chunk = np.divmod(ent_key, nchunks)
    panel_off = np.concatenate([[0], np.cumsum(
        np.bincount(ent_panel, minlength=panels))])
    # each entry's place in vals: group, lane, tile of the group, slot
    t = pos[tile_of]
    within = (row % TILE) * TILE + col % TILE
    lane, slot = FRAG
    dest = (((t // g) * 32 + lane[within]) * g + t % g) * 8 + slot[within]
    out = torch.zeros(int(rg_off[-1]) * TILE * TILE, dtype=vals.dtype)
    out[torch.from_numpy(dest)] = vals
    if bell.packed4:
        out = pack_nibbles(out)
    i32 = np.int32
    return TilePacked(
        vals=out.to(bell.device),
        ent=torch.from_numpy(((ent_chunk << 4) | mask).astype(i32)).to(
            bell.device),
        panel_off=torch.from_numpy(panel_off.astype(i32)).to(bell.device),
        rg_off=torch.from_numpy(rg_off.astype(i32)).to(bell.device),
        shape=(int(m), int(n)), live=int(len(row)), tiles=int(len(tile_key)),
        packed4=bool(bell.packed4))


def _to_torch(arr, device, dtype):
    if arr.dtype.name == "bfloat16":  # ml_dtypes array handed over from JAX
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def bucketed_block_ell_from_csr(csr, block=(8, 128), dtype=np.float32,
                                n_buckets: int = 4,
                                row_group: int = 8,
                                pack_int4: bool = False,
                                device="cuda") -> BucketedBlockELL:
    """Host conversion CSR -> sliced/bucketed block-ELL.

    Same packing as the JAX package: ``row_group`` (block-rows per Pallas
    grid step there) has no meaning to the CUDA kernel but still fixes the
    bucket padding and the bucket cap, which keeps the panels identical.

    ``dtype``: numpy storage dtype, or ``torch.bfloat16`` (packed in float32
    on the host, rounded to bfloat16 by torch).  ``device``: where the panel
    lives; the default is the card, and it raises without one.
    ``pack_int4``: the CSR values must already be integers in [-7, 7]; the
    panel is the logical int8 panel of the JAX ``packed4`` one (each
    bucket's block axis padded to even, as the nibble packing pads it),
    marked ``packed4``.
    """
    import scipy.sparse as sp

    if pack_int4:
        dtype = np.int8
    device = require_device(device)
    torch_dtype = dtype if isinstance(dtype, torch.dtype) else None
    np_dtype = np.float32 if torch_dtype is not None else np.dtype(dtype)

    br, bc = block
    m, n = csr.shape
    m_pad = -(-m // br) * br
    n_pad = -(-n // bc) * bc
    csr_pad = sp.csr_matrix((csr.data, csr.indices, csr.indptr), shape=(m, n))
    csr_pad.resize((m_pad, n_pad))
    bsr = csr_pad.tobsr(blocksize=block)
    bsr.sort_indices()
    nbr = m_pad // br
    counts = np.diff(bsr.indptr)

    # the JAX packer's cap: keep >= ~16 row groups per bucket
    max_buckets = max(1, nbr // (row_group * 16))
    n_buckets = min(n_buckets, max_buckets)

    order = np.argsort(-counts, kind="stable")  # descending block count
    bounds = np.linspace(0, nbr, n_buckets + 1).astype(int)
    buckets = []
    sorted_rows = []
    for bi in range(n_buckets):
        rows = order[bounds[bi]:bounds[bi + 1]]
        if len(rows) == 0:
            continue
        nbr_b = -(-len(rows) // row_group) * row_group
        maxb_b = max(int(counts[rows].max()), 1)
        blocks = np.zeros((nbr_b, maxb_b, br, bc), np_dtype)
        bcols = np.zeros((nbr_b, maxb_b), np.int32)
        lens = counts[rows]
        total = int(lens.sum())
        if total:
            dest_r = np.repeat(np.arange(len(rows)), lens)
            offs = np.arange(total) - np.repeat(
                np.concatenate([[0], np.cumsum(lens)[:-1]]), lens
            )
            src = np.repeat(bsr.indptr[rows], lens) + offs
            blocks[dest_r, offs] = bsr.data[src].astype(np_dtype)
            bcols[dest_r, offs] = bsr.indices[src]
        if pack_int4 and maxb_b % 2:   # the JAX nibble packing's padding
            blocks = np.concatenate([blocks, np.zeros_like(blocks[:, :1])],
                                    axis=1)
            bcols = np.concatenate([bcols, np.zeros_like(bcols[:, :1])],
                                   axis=1)
        buckets.append((blocks, bcols))
        sorted_rows.append(np.concatenate(
            [rows, np.full(nbr_b - len(rows), -1, dtype=np.int64)]
        ))
    sorted_rows = np.concatenate(sorted_rows)  # position -> orig row (-1 pad)
    inv_perm = np.zeros(nbr, np.int32)
    valid = sorted_rows >= 0
    inv_perm[sorted_rows[valid]] = np.nonzero(valid)[0].astype(np.int32)
    return BucketedBlockELL._from_logical(
        buckets, inv_perm, (m, n), n_pad // bc, pack_int4, device,
        torch_dtype)


@dataclass
class ELLMatrix:
    """Padded row-major ELL: ``A[i, idx[i, j]] = vals[i, j]``; padded
    entries point at column 0 and hold 0.  Build with
    :func:`ell_from_csr`."""

    idx: torch.Tensor     # (rows, width) int32
    vals: torch.Tensor    # (rows, width)
    shape: tuple

    def matvec(self, x):
        """``y = A x``: a gather of ``x`` and a sum along each row, in the
        promoted type of the values and ``x``."""
        return torch.sum(self.vals * x[self.idx.long()], dim=1)


def ell_from_csr(csr, dtype=np.float32, device="cuda") -> ELLMatrix:
    """Host conversion CSR -> :class:`ELLMatrix`, each row padded to the
    longest.  ``device``: where it lives; the default is the card, and it
    raises without one."""
    device = require_device(device)
    rows = csr.shape[0]
    width = int(np.diff(csr.indptr).max()) if rows else 0
    idx = np.zeros((rows, width), np.int32)
    vals = np.zeros((rows, width), dtype)
    counts = np.diff(csr.indptr)
    r = np.repeat(np.arange(rows), counts)
    within = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], counts)
    idx[r, within] = csr.indices
    vals[r, within] = csr.data.astype(dtype)
    return ELLMatrix(torch.as_tensor(idx, device=device),
                     torch.as_tensor(vals, device=device), tuple(csr.shape))


@dataclass
class BlockELLMatrix:
    """Block-ELL (padded BSR): dense (BR x BC) blocks and, per block-row, a
    padded list of block-column indices.  Padded slots have block column 0
    and zero blocks, so an unconditional sum is exact.  Build with
    :func:`block_ell_from_csr`."""

    blocks: torch.Tensor   # (nbr, maxb, BR, BC)
    bcols: torch.Tensor    # (nbr, maxb) int32, padded: 0
    nblocks: torch.Tensor  # (nbr,) int32: valid blocks per block-row
    shape: tuple           # logical (m, n) before padding

    @property
    def block_shape(self):
        return tuple(self.blocks.shape[2:])

    @property
    def padded_shape(self):
        nbr, _, br, bc = self.blocks.shape
        return (nbr * br, self.bcols_cols * bc)

    @property
    def bcols_cols(self):
        """Block columns of the padded matrix."""
        return -(-self.shape[1] // self.blocks.shape[3])

    def matvec(self, x):
        """Plain PyTorch ``y = A x``: ``x`` padded and gathered by block
        column, one einsum over the blocks, summed in float32 or the
        blocks' type if wider; returns ``x.dtype``."""
        nbr, _, br, bc = self.blocks.shape
        acc = torch.promote_types(torch.float32, self.blocks.dtype)
        x_pad = torch.zeros(self.bcols_cols * bc, dtype=acc, device=x.device)
        x_pad[: self.shape[1]] = x.to(acc)
        xg = x_pad.view(self.bcols_cols, bc)[self.bcols.long()]
        y = torch.einsum("rbij,rbj->ri", self.blocks.to(acc), xg)
        return y.reshape(nbr * br)[: self.shape[0]].to(x.dtype)


def block_ell_from_csr(csr, block=(8, 128), dtype=np.float32,
                       row_group: int = 1, device="cuda") -> BlockELLMatrix:
    """Host conversion CSR -> :class:`BlockELLMatrix`, the JAX packer's.

    ``row_group``: the block-rows are padded to a multiple of it.
    ``dtype``: numpy storage dtype, or ``torch.bfloat16`` (packed in float32
    on the host, rounded by torch).  ``device``: where it lives; the
    default is the card, and it raises without one."""
    import scipy.sparse as sp

    device = require_device(device)
    torch_dtype = dtype if isinstance(dtype, torch.dtype) else None
    np_dtype = np.float32 if torch_dtype is not None else np.dtype(dtype)
    br, bc = block
    m, n = csr.shape
    m_pad = -(-m // (br * row_group)) * (br * row_group)
    n_pad = -(-n // bc) * bc
    csr_pad = sp.csr_matrix((csr.data, csr.indices, csr.indptr), shape=(m, n))
    csr_pad.resize((m_pad, n_pad))
    bsr = csr_pad.tobsr(blocksize=block)
    bsr.sort_indices()
    nbr = m_pad // br
    counts = np.diff(bsr.indptr)
    maxb = int(counts.max()) if nbr else 0
    blocks = np.zeros((nbr, maxb, br, bc), np_dtype)
    bcols = np.zeros((nbr, maxb), np.int32)
    r = np.repeat(np.arange(nbr), counts)
    within = np.arange(bsr.indptr[-1]) - np.repeat(bsr.indptr[:-1], counts)
    blocks[r, within] = bsr.data.astype(np_dtype)
    bcols[r, within] = bsr.indices
    return BlockELLMatrix(
        _to_torch(blocks, device, torch_dtype),
        torch.as_tensor(bcols, device=device),
        torch.as_tensor(counts.astype(np.int32), device=device), (m, n))
