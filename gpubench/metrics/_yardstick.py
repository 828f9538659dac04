"""The roofline yardstick of the operator products: the least bytes and
operations a product needs, whatever implements it, and the H100's published
peaks (NVIDIA's data sheet, SXM part, dense, at the full 700 W; the run
prints the card's power limit beside its result).

For a product of an m x n operator with ``nnz`` stored entries on R
columns: bytes = nnz x the value width of the storage type + the row scales
of a quantized type (4 bytes a row) + the input block read once + the
output block written once (float32); index bytes are left out (a format
choice: no kernel can read less than this).  Operations = 2 nnz R.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
TENSOR_PEAK = {"int8": 1979e12, "int4": 1979e12, "bfloat16": 989e12,
               "float32": 989e12}
VALUE_BYTES = {"int4": 0.5, "int8": 1, "bfloat16": 2, "float32": 4}
SCALED = ("int8", "int4")
MULTI = ("matmat", "matmat_into", "rmatmat")
SINGLE = ("matvec", "rmatvec")


def product_bytes(m, n, nnz, cols, dtype):
    """The same for ``A X`` and ``A^T U``: one block of n rows and one of m
    rows cross, one each way."""
    scales = 4 * m if dtype in SCALED else 0
    return nnz * VALUE_BYTES[dtype] + scales + 4 * cols * (m + n)


def product_ops(nnz, cols):
    return 2.0 * nnz * cols


def bound_s(m, n, nnz, cols, dtype):
    """The least time the card could take: the larger of the bytes over
    HBM bandwidth and the operations over the tensor-core peak."""
    return max(product_bytes(m, n, nnz, cols, dtype)
               / HBM_BYTES_PER_S, product_ops(nnz, cols) / TENSOR_PEAK[dtype])


def roofline_pct(ctx, methods):
    """100 x the sum of bounds / the sum of device time over every product
    call of ``methods`` in the traced window; None where there is none."""
    if ctx.trace is None:
        return None
    dtype = ctx.cfg["dtype"]
    bound = busy = 0.0
    for op, method, cols, sec in ctx.trace.span_calls():
        if method not in methods or sec <= 0:
            continue
        m, n, nnz = ctx.facts[op]
        bound += bound_s(m, n, nnz, cols, dtype)
        busy += sec
    return None if busy <= 0 else 100.0 * bound / busy
