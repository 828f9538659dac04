"""The roofline yardstick: bytes, operations and bounds from shapes, and
the share over a traced window's product calls."""

import pytest

from gpubench.metrics import _yardstick as y
from gpubench.metrics import spmm_roofline_pct, spmv_roofline_pct


def test_bytes_and_ops_from_shapes():
    m, n, nnz = 129600, 16384, 26_400_000
    assert y.product_bytes(m, n, nnz, 8, "int8") == nnz + 4 * m + \
        4 * 8 * (m + n)
    assert y.product_bytes(m, n, nnz, 1, "bfloat16") == 2 * nnz + \
        4 * (m + n)
    assert y.product_bytes(m, n, nnz, 1, "int4") == nnz / 2 + 4 * m + \
        4 * (m + n)
    assert y.product_ops(nnz, 100) == 2 * nnz * 100


def test_bound_is_the_larger_of_bytes_and_operations():
    m, n, nnz = 129600, 16384, 26_400_000
    t8 = y.bound_s(m, n, nnz, 8, "int8")
    assert t8 == pytest.approx(y.product_bytes(m, n, nnz, 8, "int8")
                               / 3.35e12)
    # a block so wide that the operations bound it
    t = y.bound_s(10, 10, 10**9, 10**4, "bfloat16")
    assert t == pytest.approx(2 * 10**13 / 989e12)


class _Trace:
    def __init__(self, calls):
        self._calls = calls

    def span_calls(self):
        return self._calls


class _Ctx:
    def __init__(self, calls, dtype="int8"):
        self.trace = _Trace(calls)
        self.cfg = dict(dtype=dtype)
        self.facts = {"A": (1000, 200, 5000), "B": (200, 1000, 3000)}


def test_share_over_calls_and_silence_without_them():
    bA = y.bound_s(1000, 200, 5000, 8, "int8")
    bB = y.bound_s(200, 1000, 3000, 8, "int8")
    ctx = _Ctx([("A", "matmat", 8, 4 * bA), ("B", "matmat", 8, 2 * bB),
                ("A", "matvec", 1, 1.0)])
    assert spmm_roofline_pct.read(ctx) == pytest.approx(
        100 * (bA + bB) / (4 * bA + 2 * bB))
    # a call at its bound reads 100%, never more
    at = _Ctx([("A", "matmat", 8, bA)])
    assert spmm_roofline_pct.read(at) == pytest.approx(100.0)
    assert spmv_roofline_pct.read(_Ctx([("A", "matmat", 8, 1.0)])) is None
    no = _Ctx([])
    no.trace = None
    assert spmm_roofline_pct.read(no) is None
