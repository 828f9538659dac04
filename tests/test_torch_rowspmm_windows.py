"""PyTorch port: the window form and the window kernel of the redesigned
K2/K4 (``row_spmm_window`` in ``csrc/row_spmv.cu``: each thread block's
columns of X staged in shared memory).

The window form (``ops/sparse.py:RowWindows``) holds, beside a row-packed
form, each window's distinct columns and every stored slot's position in its
window's list.  These tests check that it holds the row form's matrix
exactly, walk the kernel's staging and local indices in numpy against the
walk of the row-packed kernel (``tests/test_torch_rowspmm.py``), bit for
bit, and hold the plain versions on the forms it rebuilds to the JAX
interpret-mode K2/K4.  A CUDA kernel does not run here: on CPU tensors the
wrappers take their plain versions, and a CPU form holds no window form
(one on the card makes it with the form).
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import test_torch_rowspmm as rowspmm
from hybrid_gmres_tpu.ops import spmv_pallas as jspmv
from hybrid_gmres_tpu_torch.ops import sparse as tsparse
from hybrid_gmres_tpu_torch.ops import spmv_cuda as tspmv
from hybrid_gmres_tpu_torch.utils.convert import operator_from_numpy

# Both packages multiply the same stored values by the same float32 columns
# and accumulate in float32; only the summation order differs, so
# ||Y_port - Y_jax||_inf <= 1e-5 ||Y_jax||_inf.
RTOL = 1e-5
DTYPES = ("int8", "int4", "bfloat16", "float32")


def _ct16_csr_pair():
    from hybrid_gmres_tpu_torch.ops.ordering import morton_perm, reorder_pair
    from hybrid_gmres_tpu_torch.problems.ct import ct_mismatched

    prob = ct_mismatched(n=16, n_angles=24, n_det=24)
    g = prob.geom
    return reorder_pair(prob.A_csr.astype(np.float32),
                        prob.B_csr.astype(np.float32),
                        morton_perm(g.n_angles, g.n_det),
                        morton_perm(g.n, g.n))


def _forms(op):
    return {"forward": op.fwd_rows, "transposed": op.adj_rows}


def _built(rp, threads=tsparse.WINDOW_THREADS,
           max_cols=tsparse.WINDOW_MAX_COLS):
    """``row_windows_from(rp)`` for blocks of ``threads`` and lists of at
    most ``max_cols`` columns."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(tsparse, "WINDOW_THREADS", threads)
        m.setattr(tsparse, "WINDOW_MAX_COLS", max_cols)
        return tsparse.row_windows_from(rp)


def _check_form(rp, wf, max_cols=tsparse.WINDOW_MAX_COLS,
                threads=tsparse.WINDOW_THREADS):
    """The window form holds the row form's matrix: every slot's column
    through its window's list, sorted distinct lists within the budget,
    windows covering the rows in order, none over a block's rows."""
    assert wf.rows_per_window == max(threads // rp.lanes, 1)
    assert torch.equal(wf.slot_cols(rp), rp.col_index())
    assert wf.local.dtype == torch.int16
    assert wf.local.shape == rp.cols.shape
    win_off, win_row = wf.win_off.long(), wf.win_row.long()
    sizes = win_off[1:] - win_off[:-1]
    # the places hold every packed row once, in the order of the rows held
    assert torch.equal(torch.sort(wf.rows.long()).values,
                       torch.arange(rp.shape[0]))
    assert bool((rp.row_map.long()[wf.rows.long()].diff() > 0).all())
    assert int(win_row[0]) == 0 and int(win_row[-1]) == rp.shape[0]
    rows = win_row[1:] - win_row[:-1]
    assert bool((rows >= 1).all()) and bool(
        (rows <= wf.rows_per_window).all())
    assert wf.max_cols == int(sizes.max()) <= max_cols
    assert bool(((wf.local.long() & 0xFFFF)
                 < sizes[wf.slot_windows(rp)]).all())
    for w in range(wf.windows):
        lst = wf.wcols[win_off[w]:win_off[w + 1]].long()
        assert bool((lst[1:] > lst[:-1]).all())       # sorted, distinct
        assert bool(((lst >= 0) & (lst < rp.shape[1])).all())


@pytest.mark.parametrize("dtype", DTYPES)
def test_window_form_holds_the_row_form(dtype):
    """The window forms of CT n=16's A and B, forward and transposed, in
    every storage type (16-bit column indices), and of a random matrix of
    70000 columns (32-bit indices: the local indices stay 16-bit); the
    forms on the CPU hold none."""
    A, B = _ct16_csr_pair()
    wide = sp.random(300, 70000, density=0.002, format="csr",
                     random_state=np.random.RandomState(2))
    for csr in (A, B, wide):
        op = tspmv.BlockELLOperator.from_csr(csr, dtype=dtype,
                                             with_adjoint=False,
                                             device="cpu")
        for rp in _forms(op).values():
            assert rp.wide == (rp.shape[1] > tsparse.U16_COLS)
            assert rp.wins is None
            wf = tsparse.row_windows_from(rp)
            _check_form(rp, wf)
            assert wf.seconds >= 0 and wf.nbytes > 0
            assert wf.reuse == rp.cols.numel() / max(wf.listed, 1)
            # another block size: windows of its rows
            _check_form(rp, _built(rp, threads=512),
                        threads=512)


def test_windows_are_cut_to_the_budget():
    """A block whose rows read more columns than a buffer holds is cut into
    equal windows of half, a quarter, ... of its rows; a row that alone
    reads more gives no window form (and the rule keeps the gather); a copy
    of a CPU form holds none either."""
    csr = sp.random(64, 3000, density=0.05, format="csr",
                    random_state=np.random.RandomState(3))
    op = tspmv.BlockELLOperator.from_csr(csr, dtype="int8",
                                         with_adjoint=False, device="cpu")
    rp = op.fwd_rows
    full = tsparse.row_windows_from(rp)
    # the most columns one row reads: windows of a row each
    per_row = _built(rp, threads=rp.lanes).max_cols
    for budget in (full.max_cols, full.max_cols // 3, per_row):
        wf = _built(rp, max_cols=budget)
        _check_form(rp, wf, budget)
        rows = wf.win_row[1:] - wf.win_row[:-1]
        # whole blocks while they fit, cut ones below the full budget
        assert bool((rows[:-1] == wf.rows_per_window).all()) == (
            budget == full.max_cols)
    assert _built(rp, max_cols=per_row - 1) is None
    assert tsparse.kept_windows(rp) is None
    narrow = dataclasses.replace(rp)
    assert narrow.wins is None and not tspmv.takes_windows(narrow, 8)
    assert rp.to("cpu") is rp
    with pytest.raises(ValueError, match="16-bit"):
        _built(rp, max_cols=tsparse.U16_COLS + 1)


def _window_walk(rp, wf, X, in_scale, out_scale):
    """The window kernel's walk in numpy float32: for each tile of RT = 8
    columns, each window's list staged (X read through its strides, nothing
    past the tile's width, times ``in_scale`` for K4: the float32 product
    the row-packed kernel forms at its gather), the lanes of each of the
    window's rows (group g = place - its first place, fewer than a block
    holds)
    summing their vectors slot by slot from the staged columns through the
    local indices, then the row-packed kernel's butterfly and epilogue.
    The rows of a window are the packed rows at its places."""
    rows, ncols = rp.shape
    V, L, RT = tsparse.VEC, rp.lanes, tspmv.RHS_TILE
    R = X.shape[1]
    sx0, sx1 = (st // X.itemsize for st in X.strides)
    buf = (X.base if X.base is not None else X).reshape(-1)
    vec_off = rp.vec_off.numpy().astype(np.int64)
    local = (wf.local.numpy().astype(np.int64) & 0xFFFF).reshape(-1, V)
    vals = rp.entry_values().to(torch.float32).numpy().reshape(-1, V)
    win_off, win_row = wf.win_off.numpy(), wf.win_row.numpy()
    wcols = wf.wcols.numpy().astype(np.int64)
    places = wf.rows.numpy()
    Y = np.full((rows, R), np.nan, np.float32)
    for c0 in range(0, R, RT):
        w = min(RT, R - c0)
        acc = np.zeros((rows, L, RT), np.float32)
        for win in range(wf.windows):
            lst = wcols[win_off[win]:win_off[win + 1]]
            # nothing past the tile's width: NaN here, never written
            staged = np.full((len(lst), RT), np.nan, np.float32)
            for t in range(w):
                staged[:, t] = buf[lst * sx0 + (c0 + t) * sx1]
            if in_scale is not None:
                staged = (staged * in_scale[lst][:, None]).astype(np.float32)
            p0, p1 = win_row[win], win_row[win + 1]
            assert p1 - p0 <= wf.rows_per_window
            for r in places[p0:p1]:
                for lane in range(L):
                    for k in range(vec_off[r] + lane, vec_off[r + 1], L):
                        for j in range(V):
                            acc[r, lane] += vals[k, j] * staged[local[k, j]]
        got = rowspmm._butterfly(acc, L, w)
        Y[rp.row_map.numpy(), c0:c0 + w] = got[:, :w]
    return Y if out_scale is None else out_scale[:, None] * Y


@pytest.mark.parametrize("vecs_per_lane,max_lanes,budget", [
    (2, 256, None), (1, 256, None), (16, 4, None), (1, 1, None),
    (2, 256, "cut")])
def test_window_walk_equals_the_row_kernel_walk(vecs_per_lane, max_lanes,
                                                budget, monkeypatch):
    """The window kernel's walk against the row-packed kernel's
    (``test_torch_rowspmm._kernel_walk``), bit for bit, on forms of 1 to 64
    lanes (several warps a row), windows of a whole block and windows cut
    to a small budget, the forward form (row scale in the epilogue) and the
    transposed one (the scale multiplied in while staging), R=11 (a full
    tile and a ragged one) in the row-major and the transposed layout; and
    both against the plain versions."""
    monkeypatch.setattr(tsparse, "VECS_PER_LANE", vecs_per_lane)
    monkeypatch.setattr(tsparse, "MAX_LANES", max_lanes)
    csr = sp.random(120, 600, density=0.3, format="csr",
                    random_state=np.random.RandomState(0))
    op = tspmv.BlockELLOperator.from_csr(csr, dtype="int8",
                                         with_adjoint=False, device="cpu")
    s = op.fwd_scale.numpy()
    rng = np.random.default_rng(3)
    X = rng.standard_normal((600, 11)).astype(np.float32)
    U = rng.standard_normal((120, 11)).astype(np.float32)
    cut = False
    for rp, V, ins, outs in ((op.fwd_rows, X, None, s),
                             (op.adj_rows, U, s, None)):
        cap = tsparse.WINDOW_MAX_COLS
        if budget == "cut":   # half the longest list, at least a row's
            cap = max(tsparse.row_windows_from(rp).max_cols // 2,
                      _built(rp, threads=rp.lanes).max_cols)
        wf = _built(rp, max_cols=cap)
        _check_form(rp, wf, cap)
        cut |= bool(((wf.win_row[1:-1] - wf.win_row[:-2])
                     < wf.rows_per_window).any())
        want = tspmv._row_plain(
            rp, torch.from_numpy(V),
            None if ins is None else torch.from_numpy(ins),
            None if outs is None else torch.from_numpy(outs)).numpy()
        for layout in (V, np.ascontiguousarray(V.T).T):
            got = _window_walk(rp, wf, layout, ins, outs)
            assert np.isfinite(got).all()        # every entry written once
            np.testing.assert_array_equal(
                got, rowspmm._kernel_walk(rp, layout, ins, outs))
            rowspmm._close(got, want)
    assert cut == (budget is not None)


def _leaves(bell):
    return dict(buckets=[(np.asarray(b), np.asarray(c))
                         for b, c in bell.buckets],
                inv_perm=np.asarray(bell.inv_perm), shape=bell.shape,
                ncb=bell.ncb, packed4=bell.packed4)


def _through_windows(rp):
    """The row form with its columns read back through its window form:
    what the window kernel multiplies."""
    wf = tsparse.row_windows_from(rp)
    cols = wf.slot_cols(rp)
    cols = cols.to(torch.int32) if rp.wide else cols.to(torch.int32).to(
        torch.int16)
    return dataclasses.replace(rp, cols=cols)


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_versions_on_window_forms_match_jax_interpret(dtype):
    """CT n=16's A in every storage type: the plain K2 and K4 on the forms
    read back through their window forms against the JAX package's
    ``PallasBSROperator`` on the same panel, its Pallas K2/K4 in interpret
    mode (K4 from the forward panel), at R = 1, 3, 8, 12; and the same bits
    as the plain versions on the row forms themselves."""
    A, _ = _ct16_csr_pair()
    jop = jspmv.PallasBSROperator.from_csr(
        A, block=(32, 128), dtype="int4" if dtype == "int4" else
        jnp.dtype(dtype), with_adjoint=False, interpret=True)
    s = None if jop.fwd_scale is None else np.asarray(jop.fwd_scale)
    op = operator_from_numpy(_leaves(jop.fwd), fwd_scale=s, device="cpu")
    st = op.fwd_scale
    fwd, tr = _through_windows(op.fwd_rows), _through_windows(op.adj_rows)
    m, n = A.shape
    rng = np.random.default_rng(1)
    X = rng.standard_normal((n, 12)).astype(np.float32)
    U = rng.standard_normal((m, 12)).astype(np.float32)
    want = {R: (np.asarray(jop.matmat(jnp.asarray(X[:, :R]))),
                np.asarray(jop.rmatmat(jnp.asarray(U[:, :R]))))
            for R in (1, 12)}
    for R in (1, 3, 8, 12):
        Y_j, Z_j = want[R] if R in want else (w[:, :R] for w in want[12])
        Xr, Ur = torch.from_numpy(X[:, :R]), torch.from_numpy(U[:, :R])
        Y = tspmv.row_matmat_plain(fwd, Xr, st)
        Z = tspmv.row_rmatmat_plain(tr, Ur, st)
        rowspmm._close(Y.numpy(), Y_j)
        rowspmm._close(Z.numpy(), Z_j)
        assert torch.equal(Y, tspmv.row_matmat_plain(op.fwd_rows, Xr, st))
        assert torch.equal(Z, tspmv.row_rmatmat_plain(op.adj_rows, Ur, st))


def test_cpu_products_build_no_window_form(monkeypatch):
    """``matmat``, ``matmat_into`` and ``rmatmat`` of a CPU operator take
    the plain versions: no window form is built, no library loaded, no
    launch counted."""
    from hybrid_gmres_tpu_torch.ops import _build

    def boom(*a, **k):
        raise AssertionError("CPU path loaded the CUDA kernel library")

    monkeypatch.setattr(_build, "load_library", boom)
    monkeypatch.setattr(tsparse, "row_windows_from", boom)
    before = (tspmv.row_matmat.window_launches,
              tspmv.row_rmatmat.window_launches,
              tspmv.row_matmat.launches, tspmv.row_rmatmat.launches)
    op = tspmv.BlockELLOperator.from_csr(rowspmm._random_csr(), dtype="int8",
                                         with_adjoint=False, device="cpu")
    X = torch.randn(200, 6)
    Y = op.matmat(X)
    slab = torch.full((6, 305), float("nan"))
    op.matmat_into(X, slab[:, :300].T)
    assert torch.equal(slab[:, :300].T, Y) and slab[:, 300:].isnan().all()
    op.rmatmat(torch.randn(300, 6))
    tspmv.row_matmat(op.fwd_rows, X, op.fwd_scale, gather="window")
    for rp in (op.fwd_rows, op.adj_rows):
        assert rp.wins is None
    assert before == (tspmv.row_matmat.window_launches,
                      tspmv.row_rmatmat.window_launches,
                      tspmv.row_matmat.launches, tspmv.row_rmatmat.launches)
    assert not _build._LIBS


@pytest.mark.parametrize("R", [1, 4, 5, 8, 12, 13, 16, 20, 80])
def test_window_launch_checks_and_the_rule(R):
    """The checks a window launch makes, reached without a card: the block
    size, a form without a window form.  A form keeps its window form
    (:func:`kept_windows`) where its windows read each listed column at
    least WINDOW_MIN_REUSE times: a banded matrix (neighbouring rows read
    neighbouring columns) and not a random one.  The rule takes a form
    that holds one where the last tile of R columns holds more than
    WINDOW_MIN_TAIL (R = 5-8, 13-16, ...), never a form without one."""
    op = tspmv.BlockELLOperator.from_csr(rowspmm._random_csr(), dtype="int8",
                                         with_adjoint=False, device="cpu")
    rp = op.fwd_rows
    args = dict(in_scale=None, out_scale=None, out=None)
    X = torch.zeros((200, R))
    with pytest.raises(ValueError, match="threads per block"):
        tspmv._row_mm_launch("row_matmat", rp, X, gather="window",
                             threads=256, **args)
    with pytest.raises(ValueError, match="gather"):
        tspmv._row_mm_launch("row_matmat", rp, X, gather="windows", **args)
    with pytest.raises(ValueError, match="no window form"):
        tspmv._window_launch(None, 2, rp, X, [None, None], X, False)
    assert not tspmv.takes_windows(rp, R)
    band = sp.diags([np.ones(1500)] * 9, range(-4, 5), shape=(1500, 1500),
                    format="csr")
    for csr, taken in ((band, True), (sp.random(
            1024, 20000, density=5e-4, format="csr",
            random_state=np.random.RandomState(4)), False)):
        form = tspmv.BlockELLOperator.from_csr(
            csr, dtype="int8", with_adjoint=False, device="cpu").fwd_rows
        reuse = tsparse.row_windows_from(form).reuse
        assert (reuse >= tsparse.WINDOW_MIN_REUSE) == taken
        form.wins = tsparse.kept_windows(form)
        assert (form.wins is not None) == taken
        assert tspmv.takes_windows(form, R) == (
            taken and R in (5, 8, 13, 16, 80))


def test_window_forms_of_empty_rows_and_an_all_zero_matrix():
    """Rows with no entries sit in windows like any other (their lists
    hold nothing of theirs); a matrix with no entries at all has windows
    with empty lists, and its walk gives zeros."""
    csr = rowspmm._random_csr()
    csr = sp.csr_matrix(csr.multiply((np.arange(300) % 3 != 0)[:, None]))
    op = tspmv.BlockELLOperator.from_csr(csr, dtype="float32",
                                         with_adjoint=False, device="cpu")
    X = np.random.default_rng(5).standard_normal((200, 4)).astype(
        np.float32)
    for rp in _forms(op).values():
        _check_form(rp, tsparse.row_windows_from(rp))
    Y = _window_walk(op.fwd_rows, tsparse.row_windows_from(op.fwd_rows), X,
                     None, None)
    assert (Y[::3] == 0).all()
    rowspmm._close(Y, csr @ X)
    zero = tspmv.BlockELLOperator.from_csr(sp.csr_matrix((50, 40)),
                                           dtype="int8", with_adjoint=False,
                                           device="cpu")
    wf = tsparse.row_windows_from(zero.fwd_rows)
    assert wf.max_cols == 0 and wf.listed == 0 and wf.windows >= 1
    assert not _window_walk(zero.fwd_rows, wf, np.ones((40, 3), np.float32),
                            None, zero.fwd_scale.numpy()).any()
