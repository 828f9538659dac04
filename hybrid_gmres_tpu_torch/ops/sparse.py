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

Packed int4 nibble pairs (``packed4``) are not ported yet (ROADMAP).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from hybrid_gmres_tpu_torch.utils.device import require_device

_INT4_TODO = ("packed int4 panels (packed4) are not ported yet: see ROADMAP "
              "queue 1, item 5f")


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

    @classmethod
    def from_numpy(cls, buckets, inv_perm, shape, ncb, packed4=False,
                   device="cuda", dtype=None):
        """Container from numpy per-bucket ``(blocks, bcols)`` arrays.

        ``device``: where the panel lives; the default is the card, and it
        raises without one (pass ``"cpu"`` for the CPU path).
        ``dtype``: torch storage dtype (default: the blocks' own; bfloat16
        arrays from ``ml_dtypes`` are reinterpreted bit for bit).
        ``packed4=True`` (int4 nibble pairs) is rejected: not ported yet.
        """
        if packed4:
            raise NotImplementedError(_INT4_TODO)
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
    """
    import scipy.sparse as sp

    if pack_int4:
        raise NotImplementedError(_INT4_TODO)
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
        buckets.append((blocks, bcols))
        sorted_rows.append(np.concatenate(
            [rows, np.full(nbr_b - len(rows), -1, dtype=np.int64)]
        ))
    sorted_rows = np.concatenate(sorted_rows)  # position -> orig row (-1 pad)
    inv_perm = np.zeros(nbr, np.int32)
    valid = sorted_rows >= 0
    inv_perm[sorted_rows[valid]] = np.nonzero(valid)[0].astype(np.int32)
    return BucketedBlockELL.from_numpy(
        buckets, inv_perm, (m, n), n_pad // bc, device=device,
        dtype=torch_dtype)
