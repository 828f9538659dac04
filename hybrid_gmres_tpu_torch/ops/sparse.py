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
        bcols_flat = torch.as_tensor(np.concatenate(flat_c), device=device)
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
        return cls(
            buckets=tuple(views),
            inv_perm=torch.as_tensor(inv_perm, device=device),
            shape=(int(shape[0]), int(shape[1])),
            ncb=int(ncb),
            blocks_flat=blocks_flat,
            bcols_flat=bcols_flat,
            pos_off=torch.as_tensor(np.concatenate(offs), device=device),
            pos_cnt=torch.as_tensor(np.concatenate(cnts), device=device),
            pos_row=torch.as_tensor(pos_row, device=device),
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
