"""Block-ELL SpMV and SpMM on the card: kernel wrappers, plain versions,
operator.

Counterpart of ``hybrid_gmres_tpu/ops/spmv_pallas.py``.

  * :func:`bucket_matvec` replaces the Pallas kernel ``_bucket_matvec`` and
    its wrapper ``bucketed_bsr_matvec`` (K1).  On a CUDA tensor it launches
    the hand-written kernel in ``csrc/bucket_spmv.cu`` once per operator
    application (un-sort and row scale fused into its epilogue) or raises;
    on a CPU tensor it calls :func:`bucket_matvec_plain`.
  * :func:`bucket_matmat` replaces ``_bucket_matmat`` and its wrapper
    ``bucketed_bsr_matmat`` (K2) the same way, through
    ``csrc/bucket_spmm.cu``: one launch per application, one panel read for
    up to 8 right-hand sides; :func:`bucket_matmat_plain` on a CPU tensor.
  * :func:`bucket_rmatvec` (K3) and :func:`bucket_rmatmat` (K4) replace
    ``_bucket_rmatvec`` / ``_bucket_rmatmat`` and their wrappers
    ``bucketed_bsr_rmatvec`` / ``bucketed_bsr_rmatmat``: ``A^T u`` from the
    FORWARD panel through ``csrc/bucket_rspmv.cu``, which walks the
    pack-time block-column index of ``ops/sparse.py`` (every sum in a fixed
    order, so the result is the same bits from run to run and column j of K4
    is K3 on column j); :func:`bucket_rmatvec_plain` and
    :func:`bucket_rmatmat_plain` on a CPU tensor.
  * :func:`row_matvec` (K1 redesigned) and :func:`row_rmatvec` (K3
    redesigned) are the single-RHS products that ``BlockELLOperator.matvec``
    and ``.rmatvec`` run: one template in ``csrc/row_spmv.cu`` on the
    row-packed form of ``ops/sparse.py`` (int8 values, or int4 nibble
    pairs, and 16- or 32-bit column indices, 2.5-5 bytes per nonzero where
    the block-ELL panel reads 9-15), one launch per application, every sum
    in a fixed order;
    :func:`row_matvec_plain` and :func:`row_rmatvec_plain` on a CPU tensor.
  * :func:`row_matmat` (K2 redesigned) and :func:`row_rmatmat` (K4
    redesigned) are the multi-RHS products that ``.matmat``,
    ``.matmat_into`` and ``.rmatmat`` run: the same form and walk in the
    same source, each entry read once per tile of 8 right-hand sides, every
    column summed exactly as K1/K3 sum it (column j is their product on
    column j, bit for bit); where :func:`takes_windows` (the form and R),
    the window kernel (``row_spmm_window``: each thread block's columns of
    X staged in shared memory from the form's window form, the same
    sums); :func:`row_matmat_plain` and :func:`row_rmatmat_plain` on a CPU
    tensor.
  * :func:`wide_matmat` (K2w, K2 for wide right-hand-side blocks) is the
    forward multi-RHS product of large work (``R_WIDE`` columns or more,
    stored entries times columns at least ``WIDE_WORK``) on int8 and int4
    forms (:func:`takes_tiles`): ``csrc/tile_spmm.cu`` on the tile form of
    ``ops/sparse.py`` (the nonempty dense 16 x 16 tiles), integer tensor
    cores on X split per column into four planes of bytes, one call per
    application; :func:`wide_matmat_plain` on a CPU tensor.  Its columns
    are K1's within the rounding of X to its column's grid, not bit for
    bit.

The block-ELL K1-K4 stay as the direct counterparts of the Pallas kernels on
the same panel; no solver launches them, and a CUDA operator keeps its panels
on the host until ``BlockELLOperator.panels_on_device`` asks for them.

On a CUDA tensor a wrapper launches its kernel or raises; it never falls back
to the plain version.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes

import numpy as np
import torch

from hybrid_gmres_tpu_torch.ops.linear_operator import LinearOperator
from hybrid_gmres_tpu_torch.ops.sparse import (
    MAX_LANES,
    VEC,
    BucketedBlockELL,
    PANEL_ROWS,
    TILE,
    WINDOW_THREADS,
    RowPacked,
    TilePacked,
    bucketed_block_ell_from_csr,
    row_packed_from_bell,
    tile_packed_from_bell,
)
from hybrid_gmres_tpu_torch.utils.device import require_device

# kernel dtype codes, matching bucket_spmv.cu; row_spmv.cu also takes the
# int4 nibble pairs of a packed4 form
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
INT4_CODE = 3
_BLOCK_ROWS = (8, 16, 32)
# widest block each kernel takes: K1, K3 and K4 run one thread per block
# column, K2 caps its thread blocks at 512 threads
_MAX_BC = {"bucket_matvec": 1024, "bucket_matmat": 512,
           "bucket_rmatvec": 1024, "bucket_rmatmat": 1024}


def bucket_matvec_plain(bell: BucketedBlockELL, x, scale=None):
    """Plain PyTorch ``y = diag(scale) A x``: gather + einsum per bucket,
    concatenate, un-sort through ``inv_perm`` (the twin of the JAX reference
    ``BucketedBlockELL.matvec``).  Accumulates in float32 (in float64 for
    a float64 panel, which no kernel takes, as the JAX reference does);
    returns ``x.dtype``.  The row scale is applied before that cast, as
    the kernel's epilogue does."""
    br, bc = bell.block_shape
    m, n = bell.shape
    acc = torch.promote_types(torch.float32, bell.dtype)
    x_pad = torch.zeros(bell.ncb * bc, dtype=acc, device=x.device)
    x_pad[:n] = x.to(acc)
    xg2 = x_pad.view(bell.ncb, bc)
    ys = []
    for blocks, bcols in bell.buckets:
        xg = xg2[bcols.long()]                      # (nbr_b, maxb_b, bc)
        ys.append(torch.einsum("rbij,rbj->ri", blocks.to(acc), xg))
    y_sorted = torch.cat(ys, dim=0)                  # (positions, br)
    y = y_sorted[bell.inv_perm].reshape(-1)[:m]
    if scale is not None:
        y = scale * y
    return y.to(x.dtype)


def _check_launch(name, bell, x, scale, x_shape):
    """Argument checks shared by the kernel wrappers; returns the dtype
    code and the float32 contiguous ``scale`` (or None).  ``scale`` always
    has one entry per row of A: the forward kernels apply it to their
    output, the transposed ones to their input."""
    br, bc = bell.block_shape
    m = bell.shape[0]
    code = _DTYPE_CODES.get(bell.dtype)
    if code is None:
        raise TypeError(f"{name}: no kernel for {bell.dtype} blocks")
    if br not in _BLOCK_ROWS or bc % 32 or not 32 <= bc <= _MAX_BC[name]:
        raise ValueError(f"{name}: block {(br, bc)} not supported (rows in "
                         f"{_BLOCK_ROWS}, cols a multiple of 32 up to "
                         f"{_MAX_BC[name]})")
    if tuple(x.shape) != x_shape:
        raise ValueError(f"{name}: input has shape {tuple(x.shape)}, the "
                         f"operator needs {x_shape}")
    if bell.device != x.device:
        raise ValueError(f"{name}: panel on {bell.device}, input on "
                         f"{x.device}")
    if scale is not None:
        scale = scale.to(device=x.device, dtype=torch.float32).contiguous()
        if scale.shape != (m,):
            raise ValueError(f"{name}: scale must have shape (m,)")
    return code, scale


def _panel_pointers(bell):
    return (bell.blocks_flat.data_ptr(), bell.bcols_flat.data_ptr(),
            bell.pos_off.data_ptr(), bell.pos_cnt.data_ptr(),
            bell.pos_row.data_ptr())


def bucket_matvec(bell: BucketedBlockELL, x, scale=None):
    """``y = diag(scale) A x`` through K1: the CUDA kernel for a CUDA ``x``,
    the plain version for a CPU ``x``.

    One launch per call; ``bucket_matvec.launches`` counts them (the count
    moves only where the kernel is launched)."""
    if x.device.type == "cpu":
        return bucket_matvec_plain(bell, x, scale)
    if x.device.type != "cuda":
        raise ValueError(f"bucket_matvec: unsupported device {x.device}")
    br, bc = bell.block_shape
    m, n = bell.shape
    code, scale = _check_launch("bucket_matvec", bell, x, scale, (n,))
    x32 = x.to(torch.float32).contiguous()
    y = torch.empty(m, dtype=torch.float32, device=x.device)
    n_pos = bell.pos_row.shape[0]
    if n_pos:
        from hybrid_gmres_tpu_torch.ops._build import load_library

        lib = load_library("bucket_spmv")
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.bucket_matvec(
            code, br, bc, *_panel_pointers(bell), x32.data_ptr(),
            None if scale is None else scale.data_ptr(), y.data_ptr(),
            n_pos, m, n, ctypes.c_void_p(stream))
        if err:
            raise RuntimeError(f"bucket_matvec: CUDA launch failed "
                               f"(cudaError {err})")
        bucket_matvec.launches += 1
    return y.to(x.dtype)


bucket_matvec.launches = 0


def bucket_matmat_plain(bell: BucketedBlockELL, X, scale=None):
    """Plain PyTorch ``Y = diag(scale) A X`` for ``X`` (n, R): gather +
    einsum per bucket, concatenate, un-sort through ``inv_perm`` (the twin
    of the JAX reference path of ``bucketed_bsr_matmat``).  Accumulates in
    float32; returns ``X.dtype``, row-major (m, R)."""
    br, bc = bell.block_shape
    m, n = bell.shape
    R = X.shape[1]
    x_pad = torch.zeros((bell.ncb * bc, R), dtype=torch.float32,
                        device=X.device)
    x_pad[:n] = X.to(torch.float32)
    xg3 = x_pad.view(bell.ncb, bc, R)
    ys = []
    for blocks, bcols in bell.buckets:
        xg = xg3[bcols.long()]                      # (nbr_b, maxb_b, bc, R)
        ys.append(torch.einsum("rbij,rbjk->rik", blocks.to(torch.float32),
                               xg))
    y_sorted = torch.cat(ys, dim=0)                  # (positions, br, R)
    y = y_sorted[bell.inv_perm].reshape(-1, R)[:m]
    if scale is not None:
        y = scale[:, None] * y
    return y.to(X.dtype)


def bucket_matmat(bell: BucketedBlockELL, X, scale=None, out=None):
    """``Y = diag(scale) A X`` for ``X`` (n, R) through K2: the CUDA kernel
    for a CUDA ``X``, the plain version for a CPU ``X``.

    One launch per call, whatever R: the kernel walks tiles of 8 columns
    and reads the panel once per tile.  ``X`` is read through its strides,
    so a row-major (n, R) tensor and the transposed view of an (R, n) one
    (the batched solver's layout) both go in without a copy; ``Y`` comes
    back in the same orientation (for a transposed ``X``, the transposed
    view of a contiguous (R, m) tensor).  ``out``: an (m, R) tensor of
    ``X``'s device to write into, with any strides (the top rows of a taller
    slab, say); the kernel writes a float32 ``out`` in place, without a
    copy.  ``bucket_matmat.launches`` counts the launches (the count moves
    only where the kernel is launched)."""
    if X.device.type == "cpu":
        Y = bucket_matmat_plain(bell, X, scale)
        return Y if out is None else out.copy_(Y)
    if X.device.type != "cuda":
        raise ValueError(f"bucket_matmat: unsupported device {X.device}")
    br, bc = bell.block_shape
    m, n = bell.shape
    if X.ndim != 2:
        raise ValueError(f"bucket_matmat: X must be (n, R), got "
                         f"{tuple(X.shape)}")
    R = X.shape[1]
    code, scale = _check_launch("bucket_matmat", bell, X, scale, (n, R))
    X32 = X.to(torch.float32)
    transposed = X32.stride(0) == 1 and X32.stride(1) >= max(n, 1)
    if not transposed:
        X32 = X32.contiguous()
    if out is not None:
        if tuple(out.shape) != (m, R) or out.device != X.device:
            raise ValueError(f"bucket_matmat: out must be {(m, R)} on "
                             f"{X.device}")
        Y = out if out.dtype == torch.float32 else torch.empty_like(
            out, dtype=torch.float32)
    elif transposed:
        Y = torch.empty((R, m), dtype=torch.float32, device=X.device).T
    else:
        Y = torch.empty((m, R), dtype=torch.float32, device=X.device)
    n_pos = bell.pos_row.shape[0]
    if n_pos and R:
        from hybrid_gmres_tpu_torch.ops._build import load_library

        lib = load_library("bucket_spmm")
        stream = torch.cuda.current_stream(X.device).cuda_stream
        # two float4 loads per thread and block: row-major X whose rows
        # start on 16-byte boundaries
        vec = int(X32.stride(1) == 1 and X32.stride(0) % 4 == 0
                  and X32.data_ptr() % 16 == 0)
        err = lib.bucket_matmat(
            code, br, bc, *_panel_pointers(bell), X32.data_ptr(),
            None if scale is None else scale.data_ptr(), Y.data_ptr(),
            n_pos, m, n, R, X32.stride(0), X32.stride(1), Y.stride(0),
            Y.stride(1), vec, ctypes.c_void_p(stream))
        if err:
            raise RuntimeError(f"bucket_matmat: CUDA launch failed "
                               f"(cudaError {err})")
        bucket_matmat.launches += 1
    if out is not None:
        return out if Y is out else out.copy_(Y)
    return Y.to(X.dtype)


bucket_matmat.launches = 0


def _sorted_rows(bell, U, scale):
    """``diag(scale) U`` in float32, zero-padded to whole block-rows and
    gathered into the panel's sorted position order: (positions, br, R),
    zero on bucket padding positions."""
    br = bell.block_shape[0]
    m = bell.shape[0]
    nbr = -(-m // br)
    U32 = U.to(torch.float32)
    if scale is not None:
        # A = diag(s) Q  =>  A^T u = Q^T (s * u), pre-scaled in float32
        U32 = scale.to(torch.float32)[:, None] * U32
    u_pad = torch.zeros((nbr * br, U.shape[1]), dtype=torch.float32,
                        device=U.device)
    u_pad[:m] = U32
    u_pad = u_pad.view(nbr, br, -1)
    valid = bell.pos_row >= 0
    return torch.where(valid[:, None, None],
                       u_pad[bell.pos_row.long().clamp(min=0)],
                       torch.zeros((), device=U.device))


def bucket_rmatmat_plain(bell: BucketedBlockELL, U, scale=None):
    """Plain PyTorch ``Y = A^T diag(scale) U`` for ``U`` (m, R) from the
    FORWARD panel: gather the row-sorted ``U``, one einsum per bucket,
    ``index_add_`` into the (ncb, bc, R) output (the twin of the JAX
    ``bucketed_bsr_rmatmat`` / K4).  float32 accumulation; returns
    ``U.dtype``, row-major (n, R)."""
    br, bc = bell.block_shape
    n = bell.shape[1]
    R = U.shape[1]
    u_sorted = _sorted_rows(bell, U, scale)          # (positions, br, R)
    y3d = torch.zeros((bell.ncb, bc, R), dtype=torch.float32,
                      device=U.device)
    off = 0
    for blocks, bcols in bell.buckets:
        nbr_b = blocks.shape[0]
        contrib = torch.einsum("rbij,rik->rbjk", blocks.to(torch.float32),
                               u_sorted[off:off + nbr_b])
        y3d.index_add_(0, bcols.reshape(-1).long(),
                       contrib.reshape(-1, bc, R))
        off += nbr_b
    return y3d.reshape(-1, R)[:n].to(U.dtype)


def bucket_rmatvec_plain(bell: BucketedBlockELL, u, scale=None):
    """Plain PyTorch ``y = A^T (scale * u)`` from the FORWARD panel (the twin
    of the JAX ``bucketed_bsr_rmatvec`` / K3).  float32 accumulation;
    returns ``u.dtype``."""
    return bucket_rmatmat_plain(bell, u[:, None], scale)[:, 0]


def _index_pointers(bell):
    return (bell.blocks_flat.data_ptr(), bell.col_blk.data_ptr(),
            bell.col_row.data_ptr(), bell.seg_off.data_ptr(),
            bell.col_seg.data_ptr())


def _rmat_launch(name, bell, U32, scale, Y, extra):
    """One call of entry point ``name`` of the transposed library: the main
    kernel over the panel's segments, then the fixed-order sum of their
    partials into ``Y``."""
    from hybrid_gmres_tpu_torch.ops._build import load_library

    br, bc = bell.block_shape
    m, n = bell.shape
    code, scale = _check_launch(name, bell, U32, scale, tuple(U32.shape))
    n_seg = bell.seg_off.shape[0] - 1
    R = U32.shape[1] if U32.ndim == 2 else 1
    part = torch.empty((n_seg, R, bc), dtype=torch.float32,
                       device=U32.device)
    lib = load_library("bucket_rspmv")
    stream = torch.cuda.current_stream(U32.device).cuda_stream
    err = getattr(lib, name)(
        code, br, bc, *_index_pointers(bell), U32.data_ptr(),
        None if scale is None else scale.data_ptr(), part.data_ptr(),
        Y.data_ptr(), n_seg, bell.seg_len, bell.ncb, m, n, *extra,
        ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")


def bucket_rmatvec(bell: BucketedBlockELL, u, scale=None):
    """``y = A^T (scale * u)`` from the forward panel through K3: the CUDA
    kernel for a CUDA ``u``, the plain version for a CPU ``u``.  ``scale``
    (m,) is the int8 row scale, applied to ``u`` inside the kernel.

    One call is the main kernel plus its finishing pass;
    ``bucket_rmatvec.launches`` counts the calls that launched them (it
    moves nowhere else)."""
    if u.device.type == "cpu":
        return bucket_rmatvec_plain(bell, u, scale)
    if u.device.type != "cuda":
        raise ValueError(f"bucket_rmatvec: unsupported device {u.device}")
    m, n = bell.shape
    if tuple(u.shape) != (m,):
        raise ValueError(f"bucket_rmatvec: input has shape {tuple(u.shape)}, "
                         f"the operator needs {(m,)}")
    u32 = u.to(torch.float32).contiguous()
    y = torch.empty(n, dtype=torch.float32, device=u.device)
    if n:
        _rmat_launch("bucket_rmatvec", bell, u32, scale, y, ())
        bucket_rmatvec.launches += 1
    return y.to(u.dtype)


bucket_rmatvec.launches = 0


def bucket_rmatmat(bell: BucketedBlockELL, U, scale=None):
    """``Y = A^T diag(scale) U`` for ``U`` (m, R) from the forward panel
    through K4: the CUDA kernel for a CUDA ``U``, the plain version for a
    CPU ``U``.

    One call whatever R (tiles of 8 columns, one panel read each).  ``U`` is
    read through its strides, so a row-major tensor, the transposed view of
    an (R, m) one and a row slice of a taller slab all go in without a copy;
    ``Y`` comes back in the orientation of ``U`` (for a column-major ``U``,
    the transposed view of a contiguous (R, n) tensor).
    ``bucket_rmatmat.launches`` counts the calls that launched the kernel."""
    if U.device.type == "cpu":
        return bucket_rmatmat_plain(bell, U, scale)
    if U.device.type != "cuda":
        raise ValueError(f"bucket_rmatmat: unsupported device {U.device}")
    m, n = bell.shape
    if U.ndim != 2 or U.shape[0] != m:
        raise ValueError(f"bucket_rmatmat: U must be ({m}, R), got "
                         f"{tuple(U.shape)}")
    R = U.shape[1]
    U32 = U.to(torch.float32)
    if U32.stride(0) == 1 and U32.stride(1) >= max(m, 1):  # column-major
        Y = torch.empty((R, n), dtype=torch.float32, device=U.device).T
    else:
        Y = torch.empty((n, R), dtype=torch.float32, device=U.device)
    if n and R:
        _rmat_launch("bucket_rmatmat", bell, U32, scale, Y,
                     (R, U32.stride(0), U32.stride(1), Y.stride(0),
                      Y.stride(1)))
        bucket_rmatmat.launches += 1
    return Y.to(U.dtype)


bucket_rmatmat.launches = 0

# Stage the gathered vector in shared memory (persistent blocks) when it has
# at most this many entries; otherwise gather through the read-only cache.
STAGE_MAX_COLS = 16384


def _row_plain(rp: RowPacked, v, in_scale, out_scale):
    """Plain PyTorch ``diag(out_scale) Q (in_scale * v)`` on a row-packed
    form, for ``v`` (ncols,) or (ncols, R): gather, then a fixed-order
    segment sum (``RowPacked.sum_order``).  Each row is read in its pack
    order (the source panel's block order); the entries of one source block
    (a segment) are chained with fused multiply-adds (float64 product and
    sum, one rounding to float32 each), the segments of a row added in
    order, as the block-ELL kernels of both packages sum a block and then
    the blocks.  Then the un-sort through ``row_map`` and the row scale.
    Every step is elementwise across the columns of ``v``, so column j of a
    multi-RHS product is the single-RHS product of column j, bit for bit.
    float32 results; returns ``v.dtype``."""
    src, cols, seg_steps, row_steps, rows = rp.sum_order
    V = v.to(torch.float32)
    single = V.ndim == 1
    if single:
        V = V[:, None]
    if in_scale is not None:
        V = in_scale.to(torch.float32)[:, None] * V
    R = V.shape[1]
    prod = (rp.entry_values()[src].to(torch.float64)[:, None]
            * V.to(torch.float64)[cols])
    seg = torch.zeros((seg_steps[0][0].shape[0] if seg_steps else 0, R),
                      dtype=torch.float32, device=v.device)
    for idx, at in seg_steps:
        seg[at] = (seg[at].to(torch.float64) + prod[idx]).to(torch.float32)
    runs = torch.zeros((rows.shape[0], R), dtype=torch.float32,
                       device=v.device)
    for idx, at in row_steps:
        runs[at] = runs[at] + seg[idx]
    y_packed = torch.zeros((rp.shape[0], R), dtype=torch.float32,
                           device=v.device)
    y_packed[rows] = runs
    y = torch.empty_like(y_packed)
    y[rp.row_map.long()] = y_packed
    if out_scale is not None:
        y = out_scale.to(torch.float32)[:, None] * y
    return (y[:, 0] if single else y).to(v.dtype)


def row_matvec_plain(rp: RowPacked, x, scale=None):
    """Plain PyTorch ``y = diag(scale) Q x`` on the form of the forward
    panel."""
    return _row_plain(rp, x, None, scale)


def row_rmatvec_plain(rp: RowPacked, u, scale=None, out_scale=None):
    """Plain PyTorch ``y = diag(out_scale) Q^T (scale * u)`` on the form of
    the transpose (or of an adjoint panel)."""
    return _row_plain(rp, u, scale, out_scale)


def _row_checks(name, rp: RowPacked, v, in_scale, out_scale):
    """The argument checks of the row-packed kernels; returns the dtype code
    and the float32 contiguous scales (or None)."""
    rows, ncols = rp.shape
    code = INT4_CODE if rp.packed4 else _DTYPE_CODES.get(rp.dtype)
    if code is None or (rp.packed4 and rp.dtype != torch.int8):
        raise TypeError(f"{name}: no kernel for {rp.dtype} values")
    if v.shape[0] != ncols:
        want = (ncols,) if v.ndim == 1 else (ncols, "R")
        raise ValueError(f"{name}: input has shape {tuple(v.shape)}, the "
                         f"operator needs {want}")
    if rp.device != v.device:
        raise ValueError(f"{name}: form on {rp.device}, input on {v.device}")
    if not 1 <= rp.lanes <= MAX_LANES or rp.lanes & (rp.lanes - 1):
        raise ValueError(f"{name}: {rp.lanes} lanes per row not supported")
    if rp.vals.data_ptr() % 16 or rp.cols.data_ptr() % 16:
        raise ValueError(f"{name}: values and indices must start on 16-byte "
                         "boundaries")
    scales = []
    for s, size in ((in_scale, ncols), (out_scale, rows)):
        if s is not None:
            s = s.to(device=v.device, dtype=torch.float32).contiguous()
            if s.shape != (size,):
                raise ValueError(f"{name}: scale must have shape {(size,)}")
        scales.append(s)
    return code, scales


def _row_launch(name, rp: RowPacked, v, in_scale, out_scale, stage):
    """Checks, then one launch of ``csrc/row_spmv.cu``; returns float32
    ``y`` (rows,)."""
    rows, ncols = rp.shape
    if v.ndim != 1:
        raise ValueError(f"{name}: input has shape {tuple(v.shape)}, the "
                         f"operator needs {(ncols,)}")
    code, scales = _row_checks(name, rp, v, in_scale, out_scale)
    if stage is None:
        stage = ncols <= STAGE_MAX_COLS
    v32 = v.to(torch.float32).contiguous()
    y = torch.empty(rows, dtype=torch.float32, device=v.device)
    if rows:
        from hybrid_gmres_tpu_torch.ops._build import load_library

        lib = load_library("row_spmv")
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = lib.row_spmv(
            code, int(rp.wide), int(bool(stage)), rp.vals.data_ptr(),
            rp.cols.data_ptr(), rp.vec_off.data_ptr(), rp.row_map.data_ptr(),
            v32.data_ptr(), *(None if s is None else s.data_ptr()
                              for s in scales),
            y.data_ptr(), rows, ncols, rp.lanes, ctypes.c_void_p(stream))
        if err:
            raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    return y


def row_matvec(rp: RowPacked, x, scale=None, stage=None):
    """``y = diag(scale) Q x`` through the redesigned K1: the CUDA kernel
    for a CUDA ``x``, the plain version for a CPU ``x``.  ``stage``: the
    kernel's variant (True: x in shared memory, False: gathered through the
    read-only cache; None: by size, see ``STAGE_MAX_COLS``); both give the
    same bits.  One launch per call; ``row_matvec.launches`` counts them."""
    if x.device.type == "cpu":
        return row_matvec_plain(rp, x, scale)
    if x.device.type != "cuda":
        raise ValueError(f"row_matvec: unsupported device {x.device}")
    y = _row_launch("row_matvec", rp, x, None, scale, stage)
    if rp.shape[0]:
        row_matvec.launches += 1
    return y.to(x.dtype)


row_matvec.launches = 0


def row_rmatvec(rp: RowPacked, u, scale=None, out_scale=None, stage=None):
    """``y = diag(out_scale) Q^T (scale * u)`` through the redesigned K3 on
    the form of the transpose: the CUDA kernel for a CUDA ``u`` (``scale``
    gathered beside ``u`` inside it: one launch, no pre-scale), the plain
    version for a CPU ``u``.  ``stage`` as in :func:`row_matvec`.
    ``row_rmatvec.launches`` counts the launches."""
    if u.device.type == "cpu":
        return row_rmatvec_plain(rp, u, scale, out_scale)
    if u.device.type != "cuda":
        raise ValueError(f"row_rmatvec: unsupported device {u.device}")
    y = _row_launch("row_rmatvec", rp, u, scale, out_scale, stage)
    if rp.shape[0]:
        row_rmatvec.launches += 1
    return y.to(u.dtype)


row_rmatvec.launches = 0

# The multi-RHS kernels' ways of reading the gathered tile of 8 columns
# (csrc/row_spmv.cu, row_spmm): through X's strides; one or two 16-byte
# loads from a row-major X.  "copy" is the packed gather after an
# interleaving copy (for K4 with the row scale multiplied in: the kernel then
# reads no scale).
GATHERS = {"strided": 0, "packed": 1}
RHS_TILE = 8
BLOCK_THREADS = (256, 1024)
# The default gather (measured on CT n=64 and n=128, PERF.md): through the
# strides while the form stays in L2 (at most a quarter of the H100's 50 MB;
# no copy launch), else the packed gather on an interleaved input.
STRIDED_MAX_FORM_BYTES = 12_500_000


def _packable(X32):
    """Row-major, rows on 16-byte boundaries, and every row readable up to R
    rounded up to a multiple of 4 (the ``packed`` gather reads whole 16-byte
    groups; what it reads past R it does not use): the ``packed`` gather
    reads it as it is."""
    ncols, R = X32.shape
    last = X32.storage_offset() + (ncols - 1) * X32.stride(0) + -(-R // 4) * 4
    return (X32.stride(1) == 1 and X32.stride(0) % 4 == 0
            and X32.data_ptr() % 16 == 0
            and last * 4 <= X32.untyped_storage().nbytes())


def _interleaved(X32, scale=None):
    """An interleaving copy of ``X32`` (ncols, R), times ``scale[:, None]``
    when given, in one launch: row-major with R rounded up to a multiple of
    4, sliced back to R.  The float32 product is the one the kernels form
    (``x * s``), so the bits do not change.  The padding is left unset: the
    packed gather reads it and uses it for nothing."""
    ncols, R = X32.shape
    Xi = torch.empty((ncols, -(-R // 4) * 4), dtype=torch.float32,
                     device=X32.device)[:, :R]
    if scale is None:
        Xi.copy_(X32)
    else:
        torch.mul(X32, scale[:, None], out=Xi)
    return Xi


def _gather_for(rp: RowPacked, X32, scaled=False):
    """The default gather: ``"strided"`` while the form stays in L2 (at most
    ``STRIDED_MAX_FORM_BYTES``), else ``"packed"`` on an input that is
    packed already (and needs no scale), else ``"copy"``."""
    if rp.nbytes <= STRIDED_MAX_FORM_BYTES:
        return "strided"
    return "packed" if _packable(X32) and not scaled else "copy"


# The window kernel (csrc/row_spmv.cu, row_spmm_window): each thread block
# stages the distinct columns of X that its rows read (the form's window
# form, ``RowPacked.wins``, kept where its windows reuse their columns) in
# shared memory and gathers from there, a tile of RHS_TILE columns at a
# time.  Its time is the walk of the windows, not the columns: a tile of
# at most 4 columns costs it 0.7-0.8 of a full one, the gathers 0.3-0.6.
# So it takes a product whose last tile holds more than WINDOW_MIN_TAIL
# columns (R = 5-8, 13-16, ...) and leaves the rest to the gathers.
# Measured on CT n=64 and n=128, A, B and their transposes, four storage
# types, at R = 1, 3, 5, 8, 12, 16, 20 (chip_smoke.py's window_kernels) and
# 8-128 (k2w_sweep; PERF.md section 6).
WINDOW_MIN_TAIL = 4


def takes_windows(rp: RowPacked, R: int) -> bool:
    """The rule of the multi-RHS products on the card: the window kernel
    for a form that holds a window form (``rp.wins``, made with the form on
    the card) where the last tile of ``R`` columns holds more than
    WINDOW_MIN_TAIL, else :func:`_gather_for`'s gather."""
    tail = R - RHS_TILE * ((R - 1) // RHS_TILE)
    return rp.wins is not None and tail > WINDOW_MIN_TAIL


def _threads_for(rp: RowPacked, gather):
    """The default block size: 1024 threads for rows of 128 lanes or more,
    and for the strided gather on rows of 32 lanes or more; else 256 (four
    blocks a multiprocessor).  Measured on the CT forms (PERF.md)."""
    big_from = 32 if gather == "strided" else 128
    return 1024 if rp.lanes >= big_from else 256


def row_matmat_plain(rp: RowPacked, X, scale=None):
    """Plain PyTorch ``Y = diag(scale) Q X`` for ``X`` (ncols, R) on the form
    of the forward panel: column j is :func:`row_matvec_plain` on column j,
    bit for bit.  Returns ``X.dtype``, row-major (rows, R)."""
    return _row_plain(rp, X, None, scale)


def row_rmatmat_plain(rp: RowPacked, U, scale=None, out_scale=None):
    """Plain PyTorch ``Y = diag(out_scale) Q^T (scale * U)`` for ``U``
    (rows of A, R) on the form of the transpose (or of an adjoint panel):
    column j is :func:`row_rmatvec_plain` on column j, bit for bit."""
    return _row_plain(rp, U, scale, out_scale)


def _row_mm_launch(name, rp: RowPacked, X, in_scale, out_scale, out,
                   gather, threads=None):
    """Checks, then one launch of ``row_spmm`` or ``row_spmm_window`` in
    ``csrc/row_spmv.cu``; returns ``(Y, gather)``: ``Y`` (rows, R) float32,
    ``out`` itself when it is float32, else a new tensor in the orientation
    of ``X``, and the gather that ran (``"window"``: the window kernel;
    None: :func:`takes_windows`, else :func:`_gather_for`).  ``threads``:
    per block (``BLOCK_THREADS``, ``WINDOW_THREADS`` for the window kernel;
    None: :func:`_threads_for`).  With an ``in_scale`` the kernel runs as
    K4.  The copy and the launch run under a profiler range named ``name``,
    which tells K2 from K4 (they share the packed gather's instantiation)
    and counts the copy with its product."""
    rows, ncols = rp.shape
    if X.ndim != 2:
        raise ValueError(f"{name}: input has shape {tuple(X.shape)}, the "
                         f"operator needs {(ncols, 'R')}")
    code, scales = _row_checks(name, rp, X, in_scale, out_scale)
    k4 = scales[0] is not None
    R = X.shape[1]
    X32 = X.to(torch.float32)
    if out is not None:
        if tuple(out.shape) != (rows, R) or out.device != X.device:
            raise ValueError(f"{name}: out must be {(rows, R)} on "
                             f"{X.device}")
        Y = out if out.dtype == torch.float32 else torch.empty(
            (rows, R), dtype=torch.float32, device=X.device)
    elif X32.stride(0) == 1 and X32.stride(1) >= max(ncols, 1):
        # the transposed view of an (R, ncols) tensor in, the same layout out
        Y = torch.empty((R, rows), dtype=torch.float32, device=X.device).T
    else:
        Y = torch.empty((rows, R), dtype=torch.float32, device=X.device)
    if gather is None:
        gather = ("window" if takes_windows(rp, R)
                  else _gather_for(rp, X32, scaled=k4))
    if gather not in GATHERS and gather not in ("copy", "window"):
        raise ValueError(f"{name}: gather {gather!r} not in "
                         f"{sorted(GATHERS) + ['copy', 'window']}")
    if threads is None:
        threads = (WINDOW_THREADS if gather == "window"
                   else _threads_for(rp, gather))
    if threads not in ((WINDOW_THREADS,) if gather == "window"
                       else BLOCK_THREADS):
        raise ValueError(f"{name}: {threads} threads per block not supported")
    if not (rows and R):
        return Y, gather
    from hybrid_gmres_tpu_torch.ops._build import load_library

    if gather == "window":
        with torch.profiler.record_function(name):
            err = _window_launch(load_library("row_spmv"), code, rp, X32,
                                 scales, Y, k4)
        if err:
            raise RuntimeError(f"{name}: CUDA launch failed (cudaError "
                               f"{err})")
        return Y, gather
    with torch.profiler.record_function(name):
        if gather == "copy" or (gather == "packed" and k4):
            # K4's packed gather reads the scaled copy, and no scale
            X32, gather = _interleaved(X32, scales[0]), "packed"
            scales[0] = None
        if gather == "packed" and not _packable(X32):
            raise ValueError(f"{name}: the packed gather needs a row-major "
                             "input with rows on 16-byte boundaries, readable "
                             "up to R rounded up to a multiple of 4")
        lib = load_library("row_spmv")
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = lib.row_spmm(
            code, int(rp.wide), int(k4), GATHERS[gather], threads,
            rp.vals.data_ptr(), rp.cols.data_ptr(), rp.vec_off.data_ptr(),
            rp.row_map.data_ptr(), X32.data_ptr(), X32.stride(0),
            X32.stride(1),
            *(None if s is None else s.data_ptr() for s in scales),
            Y.data_ptr(), Y.stride(0), Y.stride(1), rows, ncols, R,
            rp.lanes, ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    return Y, gather


def _window_launch(lib, code, rp: RowPacked, X32, scales, Y, k4):
    """One launch of ``row_spmm_window`` on ``rp``'s window form; returns
    the cudaError_t.  ``X32`` is staged in 16-byte pieces where the packed
    gather could read it (:func:`_packable`), else through its strides."""
    wf = rp.wins
    if wf is None:
        raise ValueError("row_spmm_window: the form holds no window form")
    if wf.local.device != X32.device or wf.local.data_ptr() % 16:
        raise ValueError("row_spmm_window: local indices must be on the "
                         "input's device, on a 16-byte boundary")
    rows, _ = rp.shape
    stream = torch.cuda.current_stream(X32.device).cuda_stream
    return lib.row_spmm_window(
        code, int(k4), int(_packable(X32)), rp.vals.data_ptr(),
        wf.local.data_ptr(), rp.vec_off.data_ptr(), rp.row_map.data_ptr(),
        wf.wcols.data_ptr(), wf.win_off.data_ptr(), wf.win_row.data_ptr(),
        wf.rows.data_ptr(), wf.windows, wf.max_cols, X32.data_ptr(),
        X32.stride(0), X32.stride(1),
        *(None if s is None else s.data_ptr() for s in scales), Y.data_ptr(),
        Y.stride(0), Y.stride(1), rows, X32.shape[1], rp.lanes,
        ctypes.c_void_p(stream))


def row_matmat(rp: RowPacked, X, scale=None, out=None, gather=None,
               threads=None):
    """``Y = diag(scale) Q X`` for ``X`` (ncols, R) through the redesigned
    K2: the CUDA kernel for a CUDA ``X``, the plain version for a CPU ``X``.

    One launch per call, whatever R: tiles of 8 columns, one read of the
    form each.  ``X`` is read through its strides; ``Y`` comes back in its
    orientation (for the transposed view of an (R, ncols) tensor, the
    transposed view of a contiguous (R, rows) one).  ``out``: an (rows, R)
    tensor of ``X``'s device, any strides, written in place when float32.
    ``gather``: how the kernel reads X (``"window"``: the window kernel,
    each block's columns staged in shared memory; ``"strided"``,
    ``"packed"``, or ``"copy"``: an interleaving copy, then packed; None:
    :func:`takes_windows`, else :func:`_gather_for`) and ``threads`` per
    block (see :func:`_row_mm_launch`) give the same bits.  Column j equals
    :func:`row_matvec` on column j bit for bit.  ``row_matmat.launches``
    counts the launches, ``row_matmat.window_launches`` those of the window
    kernel among them."""
    if X.device.type == "cpu":
        Y = row_matmat_plain(rp, X, scale)
        return Y if out is None else out.copy_(Y)
    if X.device.type != "cuda":
        raise ValueError(f"row_matmat: unsupported device {X.device}")
    Y, ran = _row_mm_launch("row_matmat", rp, X, None, scale, out, gather,
                            threads)
    if rp.shape[0] and X.shape[1]:
        row_matmat.launches += 1
        row_matmat.window_launches += ran == "window"
    if out is not None:
        return out if Y is out else out.copy_(Y)
    return Y.to(X.dtype)


row_matmat.launches = 0
row_matmat.window_launches = 0


def row_rmatmat(rp: RowPacked, U, scale=None, out_scale=None, gather=None,
                threads=None):
    """``Y = diag(out_scale) Q^T (scale * U)`` for ``U`` (rows of A, R)
    through the redesigned K4 on the form of the transpose: the CUDA kernel
    for a CUDA ``U`` (``scale`` gathered beside ``U``), the plain version
    for a CPU ``U``.  Layouts, ``gather``, ``threads`` and the bits as in
    :func:`row_matmat`: column j equals :func:`row_rmatvec` on column j.
    ``row_rmatmat.launches`` counts the launches,
    ``row_rmatmat.window_launches`` those of the window kernel."""
    if U.device.type == "cpu":
        return row_rmatmat_plain(rp, U, scale, out_scale)
    if U.device.type != "cuda":
        raise ValueError(f"row_rmatmat: unsupported device {U.device}")
    Y, ran = _row_mm_launch("row_rmatmat", rp, U, scale, out_scale, None,
                            gather, threads)
    if rp.shape[0] and U.shape[1]:
        row_rmatmat.launches += 1
        row_rmatmat.window_launches += ran == "window"
    return Y.to(U.dtype)


row_rmatmat.launches = 0
row_rmatmat.window_launches = 0

# K2w, the forward multi-RHS product on the tile form (csrc/tile_spmm.cu):
# the operators route a product there on the card when its form holds int8
# or int4 values, it has at least R_WIDE columns (every product of fewer
# keeps K2r's bits: serving, the GKB batch, the sharded and tiled products)
# and its work, stored entries times columns, is at least WIDE_WORK.  K2w
# pays a fixed cost a call (the split of X, a pass of the grid) that K2r
# does not, and wins once the work covers it.  Measured on CT n=64 and
# n=128, A and B, int8 and int4, R = 8..128 (chip_smoke.py's k2w_sweep on
# the basis' layout, lambda_mm_kernels on row-major blocks too; PERF.md
# section 6): K2w is faster than K2r at every swept
# product of at least 2e8 (n=128 A from R=16, n=128 B from R=20, n=64 A
# int8 from R=64, int4 from R=80) and slower at the largest ones below it
# (n=128 B at R=16, n=64 B at R=128: 1.9e8).  bf16 and float32 forms keep
# K2r at every R (their values are not integers).
R_WIDE = 16
WIDE_WORK = 200_000_000
_WIDE_CODES = {torch.int8: 2}
# K2w's grid: R's blocks of 8 columns shared out among the fewest thread
# blocks of at most MAX_NT of them each, and each panel's entries in
# segments of at least SEGMENT_ENTRIES (measured on CT n=64 and n=128,
# PERF.md).
MAX_NT = 5
SEGMENT_ENTRIES = 64
# rows of X over which the split's first pass takes a column's maximum
_GROUP_ROWS = 256


def takes_tiles(rp: RowPacked, R: int, device) -> bool:
    """The routing rule of the forward multi-RHS products: K2w
    (:func:`wide_matmat`) on the card for a form of int8 or int4 values,
    ``R >= R_WIDE`` and ``rp.live * R >= WIDE_WORK``; otherwise K2r
    (:func:`row_matmat`).  On the CPU every R keeps
    :func:`row_matmat_plain`."""
    return (torch.device(device).type == "cuda" and R >= R_WIDE
            and rp.live * R >= WIDE_WORK and rp.dtype in _WIDE_CODES)


def split_planes(X, chunks: int):
    """The split of ``csrc/tile_spmm.cu``: for each column of ``X`` (ncols,
    R), ``x ~ 2^(E-30) M`` with ``2^E <=`` the column's largest ``|x| <
    2^(E+1)`` and ``M`` the integer nearest ``x 2^(30-E)`` (ties to even;
    ``|M| < 2^31``: exact for every ``x`` within 2^7 of the largest),
    cut into its two's complement bytes ``M = 2^24 b0 + 2^16 b1 + 2^8 b2 +
    b3`` with ``b0`` in [-128, 127] and the others in [0, 255].  Returns
    ``(planes, scale)``: (4, chunks, 16, R) float32 integers (rows past
    ncols zero) and the (R,) float32 scales ``2^(E-30)``; zero for a zero
    column, NaN for one that is not finite."""
    ncols, R = X.shape
    V = torch.zeros((chunks * TILE, R), dtype=torch.float64, device=X.device)
    V[:ncols] = X.to(torch.float32)
    top = V.abs().amax(0)                                   # (R,)
    bad = ~torch.isfinite(V).all(0)
    ok = (top > 0) & ~bad
    E = torch.frexp(torch.where(ok, top, 1.0)).exponent - 1
    M = torch.round(torch.ldexp(torch.where(ok[None, :], V, 0.0),
                                (30 - E)[None, :]))
    M = M.clamp(-2147483520, 2147483520).to(torch.int64)
    planes = torch.stack([M >> 24, (M >> 16) & 255, (M >> 8) & 255,
                          M & 255]).to(torch.float32)
    scale = torch.ldexp(torch.ones_like(top), E - 30).to(torch.float32)
    scale = torch.where(ok, scale, 0.0)
    return (planes.view(4, chunks, TILE, R),
            torch.where(bad, float("nan"), scale))


def wide_matmat_plain(tp: TilePacked, X, scale=None):
    """Plain PyTorch ``Y = diag(scale) Q X`` on the tile form: ``X`` split
    as the kernel splits it (:func:`split_planes`), the products of the
    stored values with the integers ``M`` summed exactly
    (float64 holds every such sum of int8 and int4 values), times the
    column's and the row's scale, and rounded once to float32: what the
    kernel computes with one segment per panel, bit for bit.  Returns ``X.dtype``,
    row-major (rows, R)."""
    rows, ncols = tp.shape
    R = X.shape[1]
    pos, chunk, group = tp.tile_index()
    Q = tp.tile_values()[pos].to(torch.float64)       # (tiles, 16, 16)
    planes, col_scale = split_planes(X, tp.chunks)
    M = ((planes[0].double() * 256 + planes[1].double()) * 256
         + planes[2].double()) * 256 + planes[3].double()   # (chunks, 16, R)
    acc = torch.zeros((tp.rg_off.shape[0] - 1, TILE, R), dtype=torch.float64,
                      device=X.device)
    acc.index_add_(0, group, Q @ M[chunk])            # exact: any order
    y = acc.reshape(-1, R)[:rows] * col_scale.double()
    if scale is not None:
        y = scale.double()[:, None] * y
    return y.to(torch.float32).to(X.dtype)


def _wide_grid(tp: TilePacked, R: int):
    """K2w's grid: ``(blocks of columns, segments per panel)``: R's
    ``ceil(R / 8)`` blocks of 8 columns in the fewest blocks of at most
    MAX_NT of them, each panel's entries in segments of at least
    SEGMENT_ENTRIES on average."""
    panels = max(tp.panels, 1)
    nb = -(-(-(-R // 8)) // MAX_NT)
    nseg = tp.ent.numel() // (panels * SEGMENT_ENTRIES)
    return nb, int(min(max(nseg, 1), 65535))


def _wide_checks(tp: TilePacked, X, scale, out):
    """The argument checks of K2w, on any device; returns the dtype code and
    the float32 contiguous scale (or None)."""
    rows, ncols = tp.shape
    if X.ndim != 2 or X.shape[0] != ncols:
        raise ValueError(f"wide_matmat: input has shape {tuple(X.shape)}, the "
                         f"operator needs {(ncols, 'R')}")
    code = 3 if tp.packed4 else _WIDE_CODES.get(tp.dtype)
    if code is None or (tp.packed4 and tp.dtype != torch.int8):
        raise TypeError(f"wide_matmat: no kernel for {tp.dtype} values")
    R = X.shape[1]
    if scale is not None:
        scale = scale.to(device=X.device, dtype=torch.float32).contiguous()
        if scale.shape != (rows,):
            raise ValueError(f"wide_matmat: scale must have shape {(rows,)}")
    if out is not None and (tuple(out.shape) != (rows, R)
                            or out.device != X.device):
        raise ValueError(f"wide_matmat: out must be {(rows, R)} on "
                         f"{X.device}")
    return code, scale


def wide_matmat(tp: TilePacked, X, scale=None, out=None):
    """``Y = diag(scale) Q X`` for ``X`` (ncols, R) through K2w: the CUDA
    kernels for a CUDA ``X`` (the split of ``X`` into planes of bytes, then
    the tensor-core product), the plain version for a CPU ``X``.

    One call per product whatever R.  ``X`` is read through its strides;
    ``Y`` comes back in its orientation (for the transposed view of an (R,
    ncols) tensor, the transposed view of a contiguous (R, rows) one);
    ``out``: an (rows, R) tensor of ``X``'s device, any strides, written in
    place when float32.  The grid is :func:`_wide_grid`'s; a thread block
    whose columns of ``X`` are all zero (AB-RTP's masked basis past the
    step) walks none of the form.
    ``wide_matmat.launches`` counts the calls that launched the kernels
    (the split, the product and, with segments, their sum)."""
    code, scale = _wide_checks(tp, X, scale, out)
    if X.device.type == "cpu":
        Y = wide_matmat_plain(tp, X, scale)
        return Y if out is None else out.copy_(Y)
    if X.device.type != "cuda":
        raise ValueError(f"wide_matmat: unsupported device {X.device}")
    if tp.device != X.device:
        raise ValueError(f"wide_matmat: form on {tp.device}, input on "
                         f"{X.device}")
    if tp.vals.data_ptr() % 16:
        raise ValueError("wide_matmat: values must start on a 16-byte "
                         "boundary")
    rows, ncols = tp.shape
    R = X.shape[1]
    nb, nseg = _wide_grid(tp, R)
    X32 = X.to(torch.float32)
    if out is not None:
        Y = out if out.dtype == torch.float32 else torch.empty(
            (rows, R), dtype=torch.float32, device=X.device)
    elif X32.stride(0) == 1 and X32.stride(1) >= max(ncols, 1):
        Y = torch.empty((R, rows), dtype=torch.float32, device=X.device).T
    else:
        Y = torch.empty((rows, R), dtype=torch.float32, device=X.device)
    if rows and R:
        from hybrid_gmres_tpu_torch.ops._build import load_library

        with torch.profiler.record_function("wide_matmat"):
            # the split chunks (four planes of bytes, 64 a column of a
            # chunk) and the split's column maxima, exponents and scales
            xs = torch.empty(tp.chunks * 64 * 8 * -(-R // 8),
                             dtype=torch.uint8, device=X.device)
            words = torch.empty((-(-ncols // _GROUP_ROWS) + 2) * R,
                                dtype=torch.float32, device=X.device)
            part = None if nseg == 1 else torch.empty(
                (nseg, tp.panels * PANEL_ROWS, R), dtype=torch.float32,
                device=X.device)
            lib = load_library("tile_spmm")
            stream = torch.cuda.current_stream(X.device).cuda_stream
            err = lib.tile_spmm(
                code, tp.vals.data_ptr(), tp.ent.data_ptr(),
                tp.panel_off.data_ptr(), tp.rg_off.data_ptr(),
                X32.data_ptr(), X32.stride(0), X32.stride(1), xs.data_ptr(),
                words.data_ptr(),
                None if scale is None else scale.data_ptr(), Y.data_ptr(),
                Y.stride(0), Y.stride(1),
                None if part is None else part.data_ptr(), rows, ncols, R,
                nb, nseg, tp.panels, ctypes.c_void_p(stream))
        if err:
            raise RuntimeError(f"wide_matmat: CUDA launch failed "
                               f"(cudaError {err})")
        wide_matmat.launches += 1
    if out is not None:
        return out if Y is out else out.copy_(Y)
    return Y.to(X.dtype)


wide_matmat.launches = 0


def _row_quantize_csr(csr, qmax: int = 127):
    """Per-row symmetric integer quantization: ``A ~= diag(s) Q`` with
    ``s_i = max_j |A_ij| / qmax`` (1 for empty rows) and Q integer-valued in
    ``[-qmax, qmax]`` (127 for int8 storage, 7 for packed int4).

    Returns ``(csr_q, s)`` where ``csr_q`` carries the *rounded integer*
    values as float64 (so the block packer's ``astype(int8)`` is exact).
    The scales live outside the panel: ``A x = s * (Q x)`` and
    ``A^T u = Q^T (s * u)``; the CUDA kernel applies ``s`` in its epilogue.
    """
    import scipy.sparse as sp

    csr = csr.tocsr()
    m = csr.shape[0]
    absmax = np.zeros(m)
    np.maximum.at(absmax, np.repeat(np.arange(m), np.diff(csr.indptr)),
                  np.abs(csr.data))
    s = np.where(absmax > 0, absmax / qmax, 1.0)
    inv = 1.0 / s
    q = np.rint(csr.data * np.repeat(inv, np.diff(csr.indptr)))
    q = np.clip(q, -qmax, qmax)
    csr_q = sp.csr_matrix((q, csr.indices.copy(), csr.indptr.copy()),
                          shape=csr.shape)
    return csr_q, s.astype(np.float32)


def _storage_dtype(dtype):
    """A torch dtype or its name -> torch.float32 / bfloat16 / int8 /
    int4 (``torch.int4``, a dtype with no arithmetic: it names the
    nibble-packed storage)."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype, dtype)
    if dtype == torch.int4:
        return dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"unsupported panel dtype {dtype!r}")
    return dtype


class BlockELLOperator(LinearOperator):
    """Sparse operator backed by the bucketed block-ELL panels (twin of
    ``PallasBSROperator``) and, for its products, two row-packed forms
    built from them at construction (pack time, never in a solve).

    ``matvec`` and ``matmat`` run the redesigned K1 and K2
    (:func:`row_matvec`, :func:`row_matmat`) on the form of the forward
    panel, and ``matmat`` on the card K2w (:func:`wide_matmat`) on its
    tile form where :func:`takes_tiles` says so (int8 and int4 panels, large
    products; the form is built at the first such product: single solves
    and serving never build it); ``rmatvec`` and ``rmatmat`` the redesigned K3 and K4
    (:func:`row_rmatvec`, :func:`row_rmatmat`) on ``adj_rows``: the form of
    the transpose of the forward panel (``with_adjoint=False``, what
    ``ct_gpu_operators`` builds by default), or of the adjoint panel when
    one was built (``with_adjoint=True``).  For a mismatched pair, pass B as
    its own operator — B is never derived from A.

    ``dtype=int8`` stores per-row symmetrically quantized blocks with f32 row
    scales (``A ~= diag(s) Q``), applied in the kernel epilogue.  The adjoint
    panel holds the SAME quantized ``Q^T``, so ``<A x, u> == <x, A^T u>``.
    ``dtype="int4"`` quantizes the same way with ``qmax = 7``; its panels
    are ``packed4`` and its forms store two values a byte.

    ``dtype`` reports the COMPUTE dtype (float32 when quantized): reporting
    int8 would make lam-composing wrappers cast lam to int8 (1e-2 -> 0) and
    silently drop the Tikhonov term.  Storage is ``storage_dtype``
    (``torch.int4`` for an int4 operator).

    The block-ELL panels ``fwd``/``adj`` of an operator on the card live on
    the host: no product reads them, and at CT n=128 they would hold 467 MB
    of the card beside the forms.  :meth:`panels_on_device` puts them on
    the card for the block-ELL kernels K1-K4.
    """

    _tiles = None   # the tile form of K2w, built at the first wide product

    def __init__(self, fwd: BucketedBlockELL, adj=None, fwd_scale=None,
                 adj_scale=None, fro_sq=None):
        self.fwd_scale = fwd_scale  # (m,) f32: y = scale * (Q x)
        self.adj_scale = adj_scale  # (n,) f32 for the transpose panel
        self.fro_sq = fro_sq        # ||A||_F^2 of the SOURCE matrix, f32
        self.fwd_rows = row_packed_from_bell(fwd)
        self.adj_rows = (row_packed_from_bell(fwd, transpose=True)
                         if adj is None else row_packed_from_bell(adj))
        if fwd.device.type != "cpu":
            fwd = fwd.to("cpu")
            adj = None if adj is None else adj.to("cpu")
        self.fwd = fwd              # the forward panel, on the host
        self.adj = adj              # the adjoint panel (or None)

    @classmethod
    def from_csr(cls, csr, block=(8, 128), dtype=torch.float32,
                 n_buckets: int = 4, with_adjoint: bool = True,
                 device="cuda"):
        """Pack a scipy CSR matrix.  ``dtype``: float32, bfloat16, int8 or
        ``"int4"``, as a torch dtype or its name.  ``device``: where the
        panels live; the default is the card, and it raises without one
        (pass ``"cpu"`` for the CPU path)."""
        device = require_device(device)
        dt = _storage_dtype(dtype)
        is_int4 = dt == torch.int4
        np_dt = np.int8 if dt in (torch.int8, torch.int4) else (
            np.float32 if dt == torch.float32 else dt)
        fwd_scale = None
        fro_sq = torch.tensor(float((csr.multiply(csr)).sum()),
                              dtype=torch.float32, device=device)
        csr_fwd = csr
        csr_adj = csr.T.tocsr() if with_adjoint else None
        if dt in (torch.int8, torch.int4):
            csr_fwd, s = _row_quantize_csr(csr, qmax=7 if is_int4 else 127)
            fwd_scale = torch.as_tensor(s, device=device)
            if with_adjoint:
                # ONE quantization: the adjoint panel is Q^T and rmatvec
                # pre-scales u by fwd_scale (exact transpose of matvec)
                csr_adj = csr_fwd.T.tocsr()
        pack = dict(block=block, dtype=np_dt, n_buckets=n_buckets,
                    pack_int4=is_int4, device=device)
        fwd = bucketed_block_ell_from_csr(csr_fwd, **pack)
        adj = bucketed_block_ell_from_csr(csr_adj, **pack) if with_adjoint \
            else None
        return cls(fwd, adj, fwd_scale=fwd_scale, fro_sq=fro_sq)

    @property
    def shape(self):
        return self.fwd.shape

    @property
    def device(self):
        return self.fwd_rows.device

    def to(self, device) -> "BlockELLOperator":
        """The same operator with its forms, scales and ``fro_sq`` on
        ``device`` (itself if they are there already; the card raises
        without one): an operator packed on the host, moved to the card.
        The block-ELL panels stay where they are (see
        :meth:`panels_on_device`)."""
        device = require_device(device)
        if device == self.device:
            return self
        op = copy.copy(self)
        op.fwd_rows = self.fwd_rows.to(device)
        op.adj_rows = self.adj_rows.to(device)
        op._tiles = None if self._tiles is None else self._tiles.to(device)
        for name in ("fwd_scale", "adj_scale", "fro_sq"):
            t = getattr(self, name)
            setattr(op, name, None if t is None else t.to(device))
        return op

    @contextlib.contextmanager
    def panels_on_device(self):
        """The block-ELL panels ``fwd`` and ``adj`` on the operator's device
        inside the block, for the block-ELL kernels K1-K4 (which no solver
        runs), and released on exit: the host copies are back in place."""
        host = self.fwd, self.adj
        self.fwd = host[0].to(self.device)
        self.adj = None if host[1] is None else host[1].to(self.device)
        try:
            yield self
        finally:
            self.fwd, self.adj = host

    @property
    def fro_norm(self):
        """Exact ``||A||_F`` of the source matrix (None if unrecorded)."""
        return None if self.fro_sq is None else torch.sqrt(self.fro_sq)

    @property
    def dtype(self):
        if self.fwd_scale is not None:
            return torch.float32
        return self.fwd.dtype

    @property
    def storage_dtype(self):
        return torch.int4 if self.fwd.packed4 else self.fwd.dtype

    def matvec(self, x):
        return row_matvec(self.fwd_rows, x, self.fwd_scale)

    def rmatvec(self, u):
        # A = diag(s) Q  =>  A^T u = Q^T (s * u): the kernel scales u as it
        # reads it, so the pair is an exact transpose by construction
        return row_rmatvec(self.adj_rows, u, self.fwd_scale, self.adj_scale)

    @property
    def fwd_tiles(self) -> TilePacked:
        """The tile form of the forward panel (K2w's), built from the host
        panel at the first product that :func:`takes_tiles` routes to K2w
        and kept on the operator's device."""
        if self._tiles is None:
            self._tiles = tile_packed_from_bell(self.fwd).to(self.device)
        return self._tiles

    def _wide(self, X):
        return X.ndim == 2 and takes_tiles(self.fwd_rows, X.shape[1],
                                           X.device)

    def matmat(self, X):
        """Y (m, R) = A @ X (n, R): K2w (:func:`wide_matmat`, tensor cores
        on the tile form) where :func:`takes_tiles` says so, else the
        redesigned K2 (:func:`row_matmat`: one read of the form serves the
        8 columns of a tile)."""
        if self._wide(X):
            return wide_matmat(self.fwd_tiles, X, self.fwd_scale)
        return row_matmat(self.fwd_rows, X, self.fwd_scale)

    def matmat_into(self, X, out):
        """``matmat`` written into ``out`` (m, R), any strides, in place."""
        if self._wide(X):
            return wide_matmat(self.fwd_tiles, X, self.fwd_scale, out=out)
        return row_matmat(self.fwd_rows, X, self.fwd_scale, out=out)

    def rmatmat(self, U):
        """Y (n, R) = A^T @ U (m, R) through the redesigned K4
        (:func:`row_rmatmat`) on ``adj_rows``, ``U`` scaled by
        ``fwd_scale`` as the kernel reads it."""
        return row_rmatmat(self.adj_rows, U, self.fwd_scale, self.adj_scale)
