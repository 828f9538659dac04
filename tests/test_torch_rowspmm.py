"""PyTorch port: the redesigned K2/K4 (multi-RHS products on the row-packed
form) against the JAX package and against the single-RHS products.

``row_matmat`` / ``row_rmatmat`` take their plain PyTorch versions on CPU
tensors; the JAX multi-RHS kernels run in interpret mode on the same numpy
inputs.  The kernel's walk (tiles of 8 right-hand sides, lanes per row, the
butterfly that reduces the lanes of a warp) is emulated in numpy.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from hybrid_gmres_tpu.ops import spmv_pallas as jspmv
from hybrid_gmres_tpu_torch.ops import sparse as tsparse
from hybrid_gmres_tpu_torch.ops import spmv_cuda as tspmv
from hybrid_gmres_tpu_torch.utils.convert import bell_from_numpy

# Both packages multiply the same stored values by the same float32 columns
# and accumulate in float32; only the summation order differs, so
# ||Y_port - Y_jax||_inf <= 1e-5 ||Y_jax||_inf.
RTOL = 1e-5
RS = (1, 3, 8, 12)


def _random_csr(m=300, n=200, density=0.05, seed=0):
    return sp.random(m, n, density=density, format="csr",
                     random_state=np.random.RandomState(seed),
                     dtype=np.float64)


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float64)
    err = np.max(np.abs(np.asarray(got, np.float64) - want))
    assert err <= rtol * np.max(np.abs(want)), (err, np.max(np.abs(want)))


def _transposed(a):
    """The batched solvers' layout: the transposed view of a contiguous
    (R, rows) tensor."""
    return torch.from_numpy(np.ascontiguousarray(a.T)).T


@pytest.mark.parametrize("block", [(32, 128), (8, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_plain_versions_match_jax_interpret_kernels(block, dtype):
    """The forms built from the JAX package's own panel: ``row_matmat`` on
    the forward form against ``bucketed_bsr_matmat`` (K2) and
    ``row_rmatmat`` on the transposed form against ``bucketed_bsr_rmatmat``
    (K4), Pallas in interpret mode, the int8 row scale applied as
    ``PallasBSROperator`` applies it.  The JAX kernels run at R=1 and R=12;
    R=3 and R=8 are held to the first columns of R=12 (the same inputs)."""
    csr = _random_csr()
    jop = jspmv.PallasBSROperator.from_csr(
        csr, block=block, dtype=jnp.dtype(dtype), n_buckets=2,
        with_adjoint=False, interpret=True, row_group=1)
    bell = bell_from_numpy(
        device="cpu", buckets=[(np.asarray(b), np.asarray(c))
                               for b, c in jop.fwd.buckets],
        inv_perm=np.asarray(jop.fwd.inv_perm), shape=jop.fwd.shape,
        ncb=jop.fwd.ncb)
    fwd = tsparse.row_packed_from_bell(bell)
    tr = tsparse.row_packed_from_bell(bell, transpose=True)
    s = None if jop.fwd_scale is None else np.array(jop.fwd_scale)
    st = None if s is None else torch.from_numpy(s)
    rng = np.random.default_rng(1)
    X = rng.standard_normal((csr.shape[1], 12)).astype(np.float32)
    U = rng.standard_normal((csr.shape[0], 12)).astype(np.float32)
    SU = U if s is None else (s[:, None] * U).astype(np.float32)
    want = {}
    for R in (1, 12):
        Y_j = np.asarray(jspmv.bucketed_bsr_matmat(
            jop.fwd, jnp.asarray(X[:, :R]), interpret=True), np.float64)
        Z_j = np.asarray(jspmv.bucketed_bsr_rmatmat(
            jop.fwd, jnp.asarray(SU[:, :R]), interpret=True), np.float64)
        want[R] = (Y_j if s is None else s[:, None] * Y_j, Z_j)
    for R in RS:
        Y_j, Z_j = want[R] if R in want else (w[:, :R] for w in want[12])
        Y = tspmv.row_matmat_plain(fwd, torch.from_numpy(X[:, :R]), st)
        Z = tspmv.row_rmatmat_plain(tr, torch.from_numpy(U[:, :R]), st)
        assert Y.shape == (csr.shape[0], R) and Z.shape == (csr.shape[1], R)
        _close(Y.numpy(), Y_j)
        _close(Z.numpy(), Z_j)
    # and the operator the port builds from the same leaves does the same
    op = tspmv.BlockELLOperator(bell, fwd_scale=st)
    _close(op.matmat(torch.from_numpy(X)).numpy(), want[12][0])
    _close(op.rmatmat(torch.from_numpy(U)).numpy(), want[12][1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_columns_equal_the_single_rhs_products_exactly(dtype):
    """Column j of ``row_matmat`` / ``row_rmatmat`` is ``row_matvec`` /
    ``row_rmatvec`` on column j, bit for bit, at every R, in both layouts
    and for float64 columns (the CPU parity regime), with and without an
    adjoint panel."""
    csr = _random_csr(m=250, n=180)
    rng = np.random.default_rng(2)
    X = rng.standard_normal((180, 12))
    U = rng.standard_normal((250, 12))
    for with_adjoint in (False, True):
        op = tspmv.BlockELLOperator.from_csr(csr, dtype=dtype,
                                             with_adjoint=with_adjoint,
                                             device="cpu")
        for R in RS:
            for cast in (np.float32, np.float64):
                Xr, Ur = X[:, :R].astype(cast), U[:, :R].astype(cast)
                for Xt, Ut in ((torch.from_numpy(Xr), torch.from_numpy(Ur)),
                               (_transposed(Xr), _transposed(Ur))):
                    Y, Z = op.matmat(Xt), op.rmatmat(Ut)
                    assert Y.dtype == Z.dtype == Xt.dtype
                    for j in range(R):
                        assert torch.equal(Y[:, j], op.matvec(Xt[:, j]))
                        assert torch.equal(Z[:, j], op.rmatvec(Ut[:, j]))


def _warp_reduce(acc, lanes):
    """K1's reduction of the lanes of a row, column by column: the xor tree
    inside a warp, then the warps in order.  ``acc`` (rows, lanes, RT)."""
    idx = np.arange(lanes)
    for o in (16, 8, 4, 2, 1):
        if o < min(lanes, 32):
            acc = acc + acc[:, idx ^ o]
    total = acc[:, 0]
    for warp in range(1, lanes // 32):
        total = total + acc[:, 32 * warp]
    return total


def _butterfly(acc, lanes, w):
    """The multi-RHS kernel's reduction, lane by lane: three halving steps
    (a lane whose bit o is set keeps the upper half of its values and adds
    its partner's value of each), full xor steps after them, then the
    writers (one lane per column) and, for rows over several warps, the
    warps' sums in warp order.  Returns (rows, RT) with NaN where nothing
    was written, and checks that no column is written twice."""
    rows, L, RT = acc.shape
    idx = np.arange(L)
    wl = min(L, 32)
    held, vals = RT, acc.copy()
    base = np.zeros(L, np.int64)
    o = wl >> 1
    while o > 0 and held > 1:
        up = (idx & o) != 0
        half = held // 2
        lo, hi = vals[..., :half], vals[..., half:held]
        send = np.where(up[None, :, None], lo, hi)
        keep = np.where(up[None, :, None], hi, lo)
        vals = keep + send[:, idx ^ o]
        base += np.where(up, half, 0)
        held, o = half, o >> 1
    while o > 0:
        vals = vals + vals[:, idx ^ o]
        o >>= 1
    dup_mask = max(wl // 8, 1) - 1
    writers = np.flatnonzero((idx & dup_mask) == 0)
    nwarps = max(L // 32, 1)
    part = np.full((rows, nwarps, RT), np.nan, np.float32)
    for lane in writers:
        for t in range(held):
            col = base[lane] + t
            assert np.isnan(part[:, lane // 32, col]).all()
            part[:, lane // 32, col] = vals[:, lane, t]
    total = part[:, 0]
    for warp in range(1, nwarps):
        total = total + part[:, warp]
    total[:, w:] = np.nan
    return total


def _kernel_walk(rp, X, in_scale, out_scale):
    """The multi-RHS kernel's walk in numpy float32: tiles of RT = 8
    columns of ``X`` read through its strides (the last tile masked); in
    each, lane ``l`` of packed row ``r`` sums vectors ``vec_off[r] + l,
    + lanes, ...`` slot by slot, RT columns at once; the butterfly reduces
    the lanes, which must give K1's xor tree bit for bit; the epilogue
    scales and writes the original rows."""
    rows, ncols = rp.shape
    V, L, RT = tsparse.VEC, rp.lanes, tspmv.RHS_TILE
    R = X.shape[1]
    sx0, sx1 = (st // X.itemsize for st in X.strides)
    buf = (X.base if X.base is not None else X).reshape(-1)
    vec_off = rp.vec_off.numpy().astype(np.int64)
    cols = rp.col_index().numpy().reshape(-1, V)
    vals = rp.vals.to(torch.float32).numpy().reshape(-1, V)
    nv = np.diff(vec_off)
    vec_row = np.repeat(np.arange(rows), nv)
    k = np.arange(vec_off[-1]) - vec_off[vec_row]
    lane, step = k % L, k // L
    Y = np.full((rows, R), np.nan, np.float32)
    for c0 in range(0, R, RT):
        w = min(RT, R - c0)
        t = np.arange(RT)
        tile = np.where(t < w, buf[np.arange(ncols)[:, None] * sx0
                                   + np.minimum(c0 + t, R - 1) * sx1], 0)
        tile = tile.astype(np.float32)
        if in_scale is not None:
            tile = (tile * in_scale[:, None]).astype(np.float32)
        acc = np.zeros((rows, L, RT), np.float32)
        for q in range(int(step.max()) + 1 if len(step) else 0):
            at = step == q                 # each lane at most once
            for j in range(V):
                acc[vec_row[at], lane[at]] += (vals[at, j, None]
                                               * tile[cols[at, j]])
        got = _butterfly(acc, L, w)
        tree = _warp_reduce(acc, L)
        np.testing.assert_array_equal(got[:, :w], tree[:, :w])
        Y[rp.row_map.numpy(), c0:c0 + w] = got[:, :w]
    return Y if out_scale is None else out_scale[:, None] * Y


@pytest.mark.parametrize("vecs_per_lane,max_lanes", [(2, 256), (1, 256),
                                                     (16, 4), (1, 1)])
def test_kernel_walk_matches_plain(vecs_per_lane, max_lanes, monkeypatch):
    """A walk of the multi-RHS kernel's tiles, lanes and butterfly, for
    forms whose lane counts run from 1 to 64 (several warps per row), the
    forward form (row scale in the epilogue) and the transposed one (scale
    gathered with the tile), R=11 (a full tile and a ragged one) in the
    row-major and the transposed layout, against the plain versions."""
    monkeypatch.setattr(tsparse, "VECS_PER_LANE", vecs_per_lane)
    monkeypatch.setattr(tsparse, "MAX_LANES", max_lanes)
    csr = _random_csr(m=200, n=1000, density=0.3)
    op = tspmv.BlockELLOperator.from_csr(csr, dtype="int8",
                                         with_adjoint=False, device="cpu")
    s = op.fwd_scale.numpy()
    rng = np.random.default_rng(3)
    X = rng.standard_normal((1000, 11)).astype(np.float32)
    U = rng.standard_normal((200, 11)).astype(np.float32)
    lanes = set()
    for rp, V, ins, outs in ((op.fwd_rows, X, None, s),
                             (op.adj_rows, U, s, None)):
        lanes.add(rp.lanes)
        want = tspmv._row_plain(
            rp, torch.from_numpy(V),
            None if ins is None else torch.from_numpy(ins),
            None if outs is None else torch.from_numpy(outs)).numpy()
        for layout in (V, np.ascontiguousarray(V.T).T):
            got = _kernel_walk(rp, layout, ins, outs)
            assert np.isfinite(got).all()        # every entry written once
            _close(got, want)
    if max_lanes == 1:
        assert lanes == {1}
    elif vecs_per_lane == 1:
        assert max(lanes) > 32            # a row over several warps


def test_operator_runs_the_row_plain_versions_on_cpu(monkeypatch):
    """``matmat``, ``matmat_into`` (into a row slice of a taller slab, as
    the batched hybrid LSQR writes it) and ``rmatmat`` of a CPU operator go
    through the redesigned K2/K4's plain versions, with and without an
    adjoint panel (whose form ``rmatmat`` then uses), and neither load a
    kernel library nor count a launch."""
    from hybrid_gmres_tpu_torch.ops import _build

    def boom(*a, **k):
        raise AssertionError("CPU path loaded the CUDA kernel library")

    calls = []
    for name in ("row_matmat_plain", "row_rmatmat_plain"):
        real = getattr(tspmv, name)

        def spy(rp, *a, _real=real, _name=name):
            calls.append((_name, rp))
            return _real(rp, *a)

        monkeypatch.setattr(tspmv, name, spy)
    monkeypatch.setattr(_build, "load_library", boom)
    wrappers = (tspmv.row_matvec, tspmv.row_rmatvec, tspmv.row_matmat,
                tspmv.row_rmatmat, tspmv.bucket_matvec, tspmv.bucket_matmat,
                tspmv.bucket_rmatvec, tspmv.bucket_rmatmat)
    before = [w.launches for w in wrappers]
    csr = _random_csr(m=300, n=200)
    q, s = tspmv._row_quantize_csr(csr)
    held = sp.diags(s.astype(np.float64)) @ q
    rng = np.random.default_rng(4)
    X = rng.standard_normal((200, 5)).astype(np.float32)
    U = rng.standard_normal((300, 5)).astype(np.float32)
    for with_adjoint in (False, True):
        op = tspmv.BlockELLOperator.from_csr(csr, dtype="int8",
                                             with_adjoint=with_adjoint,
                                             device="cpu")
        calls.clear()
        Y = op.matmat(torch.from_numpy(X))
        slab = torch.full((5, 300 + 200), float("nan"))
        into = op.matmat_into(_transposed(X), slab[:, :300].T)
        Z = op.rmatmat(torch.from_numpy(U))
        assert calls == [("row_matmat_plain", op.fwd_rows),
                         ("row_matmat_plain", op.fwd_rows),
                         ("row_rmatmat_plain", op.adj_rows)]
        assert Y.shape == (300, 5) and Z.shape == (200, 5)
        assert torch.equal(slab[:, :300].T, Y) and torch.equal(into, Y)
        assert slab[:, 300:].isnan().all()
        _close(Y.numpy(), held @ X.astype(np.float64))
        _close(Z.numpy(), held.T @ U.astype(np.float64))
    assert [w.launches for w in wrappers] == before
    assert not _build._LIBS


def test_matmat_wrappers_check_their_arguments():
    """The checks a CUDA launch makes, reached without a card, and the
    device rule: a tensor that is neither on the CPU nor on a CUDA card
    raises, and nothing falls back to the plain version."""
    op = tspmv.BlockELLOperator.from_csr(_random_csr(), dtype="int8",
                                         with_adjoint=False, device="cpu")
    with pytest.raises(ValueError, match="row_matmat: unsupported device"):
        tspmv.row_matmat(op.fwd_rows, torch.zeros((200, 2), device="meta"))
    with pytest.raises(ValueError, match="row_rmatmat: unsupported device"):
        tspmv.row_rmatmat(op.adj_rows, torch.zeros((300, 2), device="meta"))
    launch = tspmv._row_mm_launch
    for X, kw, match in (
            (torch.zeros(200), {}, "operator needs"),
            (torch.zeros((300, 2)), {}, "operator needs"),
            (torch.zeros((200, 2)), dict(out_scale=torch.ones(7)),
             "scale must have shape"),
            (torch.zeros((200, 2)), dict(out=torch.zeros((300, 3))),
             "out must be"),
            (torch.zeros((200, 2)), dict(gather="bogus"), "gather"),
            (torch.zeros((200, 3)), dict(gather="packed"), "packed gather"),
            (torch.zeros((200, 8)).T.contiguous().T, dict(gather="packed"),
             "packed gather"),
            (torch.zeros((200, 8)), dict(gather="staged"), "gather"),
            (torch.zeros((200, 8)), dict(gather="copy", threads=512),
             "threads per block"),
            (torch.zeros((200, 8)), dict(threads=512), "threads per block")):
        args = dict(in_scale=None, out_scale=None, out=None, gather=None)
        args.update(kw)
        with pytest.raises(ValueError, match=match):
            launch("row_matmat", op.fwd_rows, X, **args)


def test_gather_choice_and_the_interleaving_copy(monkeypatch):
    """The default gather: through the strides while the form is at most
    ``STRIDED_MAX_FORM_BYTES``, else the packed gather on a row-major input
    that allows it (and needs no scale), else an interleaving copy; the copy
    holds the same values (times the scale, the kernels' float32 product),
    row-major on 16-byte rows, R padded to a multiple of 4.  The default
    block: 1024 threads for rows of 128 lanes or more, and for the strided
    gather on rows of 32 lanes or more; else 256."""
    monkeypatch.setattr(tsparse, "VECS_PER_LANE", 1)
    op = tspmv.BlockELLOperator.from_csr(
        _random_csr(m=50, n=4000, density=0.3), with_adjoint=False,
        device="cpu")
    rp = op.fwd_rows
    assert rp.nbytes <= tspmv.STRIDED_MAX_FORM_BYTES
    X8 = torch.randn(4000, 8)
    assert tspmv._gather_for(rp, X8) == "strided"
    monkeypatch.setattr(tspmv, "STRIDED_MAX_FORM_BYTES", rp.nbytes - 1)
    assert tspmv._gather_for(rp, X8) == "packed"
    assert tspmv._gather_for(rp, X8, scaled=True) == "copy"
    assert tspmv._gather_for(rp, X8.T.contiguous().T) == "copy"
    assert tspmv._gather_for(rp, torch.randn(4000, 5)) == "copy"
    s = torch.rand(4000) + 0.5
    for X in (X8.T.contiguous().T, torch.randn(4000, 5),
              torch.randn(4000, 12)[:, 1:]):
        Xi = tspmv._interleaved(X)
        assert torch.equal(Xi, X) and tspmv._packable(Xi)
        assert Xi.stride(1) == 1 and Xi.stride(0) % 4 == 0
        assert torch.equal(tspmv._interleaved(X, s), s[:, None] * X)
    # rows readable past R up to a multiple of 4: a padded slice is packed,
    # an unpadded row-major R=6 is not (its last row ends 8 bytes early)
    assert tspmv._packable(torch.zeros((10, 8))[:, :6])
    assert not tspmv._packable(torch.zeros((10, 6)))
    assert op.fwd_rows.lanes >= 128 > 32 > op.adj_rows.lanes
    for g, big_from in (("copy", 128), ("packed", 128), ("strided", 32)):
        for lanes in (4, 16, 32, 64, 128):
            form = tsparse.RowPacked(rp.vals, rp.cols, rp.vec_off,
                                     rp.row_map, rp.shape, lanes, rp.live,
                                     rp.group)
            assert tspmv._threads_for(form, g) == (
                1024 if lanes >= big_from else 256)


def test_empty_rows_an_all_zero_matrix_and_no_columns():
    """Rows with no entries come out as zeros, a matrix with no entries at
    all gives zero products, and R=0 gives an empty (rows, 0) result."""
    csr = _random_csr()
    csr = sp.csr_matrix(csr.multiply(
        (np.arange(300) % 3 != 0)[:, None]))        # every third row empty
    op = tspmv.BlockELLOperator.from_csr(csr, dtype="float32",
                                         with_adjoint=False, device="cpu")
    rng = np.random.default_rng(5)
    X = rng.standard_normal((200, 4)).astype(np.float32)
    U = rng.standard_normal((300, 4)).astype(np.float32)
    Y = op.matmat(torch.from_numpy(X)).numpy()
    assert (Y[::3] == 0).all()
    _close(Y, csr @ X)
    _close(op.rmatmat(torch.from_numpy(U)).numpy(), csr.T @ U)
    zero = tspmv.BlockELLOperator.from_csr(sp.csr_matrix((50, 40)),
                                           dtype="int8", with_adjoint=False,
                                           device="cpu")
    assert not zero.matmat(torch.ones((40, 3))).any()
    assert not zero.rmatmat(torch.ones((50, 3))).any()
    assert op.matmat(torch.zeros((200, 0))).shape == (300, 0)
    assert op.rmatmat(torch.zeros((300, 0))).shape == (200, 0)
