"""PyTorch port: the row-packed form and the redesigned K1/K3 against the JAX
package.

The form is built from a block-ELL panel's live blocks
(``ops/sparse.py:row_packed_from_bell``); the single-RHS products
``row_matvec`` / ``row_rmatvec`` take their plain PyTorch versions on CPU
tensors.  The JAX kernels run in interpret mode on the same numpy inputs.
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

# Both packages multiply the same stored values by the same float32 vector
# and accumulate in float32; only the summation order differs, so
# ||y_port - y_jax||_inf <= 1e-5 ||y_jax||_inf.
RTOL = 1e-5


def _random_csr(m=700, n=500, density=0.02, seed=0):
    return sp.random(m, n, density=density, format="csr",
                     random_state=np.random.RandomState(seed),
                     dtype=np.float64)


def _ct16_csr_pair():
    from hybrid_gmres_tpu.ops.ordering import morton_perm, reorder_pair
    from hybrid_gmres_tpu.problems.ct import ct_mismatched

    prob = ct_mismatched(n=16, n_angles=24, n_det=24, dense=False)
    g = prob.geom
    return reorder_pair(prob.A_csr.astype(np.float32),
                        prob.B_csr.astype(np.float32),
                        morton_perm(g.n_angles, g.n_det), morton_perm(g.n, g.n))


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float64)
    err = np.max(np.abs(np.asarray(got, np.float64) - want))
    assert err <= rtol * np.max(np.abs(want)), (err, np.max(np.abs(want)))


def _panel_dense(bell):
    """The matrix a panel holds, from its blocks, in float64."""
    br, bc = bell.block_shape
    m, n = bell.shape
    dense = np.zeros((bell.pos_row.shape[0] * br, bell.ncb * bc))
    blocks = bell.blocks_flat.to(torch.float64).numpy()
    bcols = bell.bcols_flat.numpy()
    for p in range(bell.pos_row.shape[0]):
        row = int(bell.pos_row[p])
        off = int(bell.pos_off[p])
        for j in range(int(bell.pos_cnt[p])):
            if row >= 0:
                c = int(bcols[off + j])
                dense[row * br:(row + 1) * br, c * bc:(c + 1) * bc] += \
                    blocks[off + j]
    return dense[:m, :n]


def _form_dense(rp):
    """The matrix a row-packed form holds, in float64, rows in original
    order; padding entries must be zero."""
    rows, ncols = rp.shape
    vals = rp.vals.to(torch.float64).numpy()
    cols = rp.col_index().numpy()
    off = rp.vec_off.numpy().astype(np.int64) * tsparse.VEC
    dense = np.zeros((rows, ncols))
    for r in range(rows):
        np.add.at(dense[int(rp.row_map[r])], cols[off[r]:off[r + 1]],
                  vals[off[r]:off[r + 1]])
    return dense


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("source", ["ct16_A", "ct16_B"])
def test_form_holds_the_panel_matrix_exactly(source, dtype, transpose):
    """A, A^T, B and B^T of CT n=16 in every storage type: the form holds
    exactly the panel's Q (diag(s) Q with the operator's scale), in the
    panel's storage type, with the panel's exact zeros dropped."""
    A, B = _ct16_csr_pair()
    csr, block = (A, (32, 128)) if source == "ct16_A" else (B, (8, 128))
    op = tspmv.BlockELLOperator.from_csr(csr, block=block, dtype=dtype,
                                         with_adjoint=False, device="cpu")
    rp = op.adj_rows if transpose else op.fwd_rows
    assert rp.dtype == op.fwd.dtype
    panel = _panel_dense(op.fwd)
    want = panel.T if transpose else panel
    np.testing.assert_array_equal(_form_dense(rp), want)
    assert rp.live == np.count_nonzero(want)
    assert rp.shape == want.shape
    assert 0.5 < rp.fill <= 1.0
    assert not rp.wide          # CT n=16: 2025 rays, 256 pixels
    # the scale the operator applies: diag(s) Q against the quantized CSR
    if dtype == "int8":
        q, s = tspmv._row_quantize_csr(csr)
        np.testing.assert_array_equal(panel, q.toarray())
        np.testing.assert_array_equal(op.fwd_scale.numpy(), s)


@pytest.mark.parametrize("ncols,wide", [(65536, False), (70000, True)])
def test_index_width_follows_the_column_count(ncols, wide):
    """uint16 indices (held as int16 bits) up to 65536 columns, int32
    beyond; columns past 32767 and past 65535 are read back right."""
    rng = np.random.default_rng(0)
    cols = np.concatenate([rng.choice(ncols, 200, replace=False),
                           [ncols - 1, 32768, 40000]])
    cols = np.unique(cols)
    rows = rng.integers(0, 5, len(cols))
    csr = sp.csr_matrix((rng.standard_normal(len(cols)), (rows, cols)),
                        shape=(5, ncols))
    op = tspmv.BlockELLOperator.from_csr(csr, dtype="float32",
                                         with_adjoint=False, device="cpu")
    assert op.fwd_rows.wide == wide
    assert op.fwd_rows.cols.dtype == (torch.int32 if wide else torch.int16)
    assert not op.adj_rows.wide          # the transpose has 5 columns
    x = rng.standard_normal(ncols).astype(np.float32)
    u = rng.standard_normal(5).astype(np.float32)
    _close(op.matvec(torch.from_numpy(x)).numpy(), csr @ x)
    _close(op.rmatvec(torch.from_numpy(u)).numpy(), csr.T @ u)


def _jax_leaves(jbell):
    return dict(buckets=[(np.asarray(b), np.asarray(c))
                         for b, c in jbell.buckets],
                inv_perm=np.asarray(jbell.inv_perm), shape=jbell.shape,
                ncb=jbell.ncb)


@pytest.mark.parametrize("block", [(32, 128), (8, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_plain_versions_match_jax_interpret_kernels(block, dtype):
    """The forms built from the JAX package's own panel: ``row_matvec`` on
    the forward form against ``bucketed_bsr_matvec`` (K1) and
    ``row_rmatvec`` on the transposed form against ``bucketed_bsr_rmatvec``
    (K3), Pallas in interpret mode, the int8 row scale applied as
    ``PallasBSROperator`` applies it."""
    csr = _random_csr()
    jop = jspmv.PallasBSROperator.from_csr(
        csr, block=block, dtype=jnp.dtype(dtype), n_buckets=4,
        with_adjoint=False, interpret=True, row_group=2)
    bell = bell_from_numpy(device="cpu", **_jax_leaves(jop.fwd))
    fwd = tsparse.row_packed_from_bell(bell)
    tr = tsparse.row_packed_from_bell(bell, transpose=True)
    s = None if jop.fwd_scale is None else np.array(jop.fwd_scale)
    st = None if s is None else torch.from_numpy(s)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(csr.shape[1]).astype(np.float32)
    u = rng.standard_normal(csr.shape[0]).astype(np.float32)
    y_j = np.asarray(jspmv.bucketed_bsr_matvec(jop.fwd, jnp.asarray(x),
                                               interpret=True), np.float64)
    su = u if s is None else (s * u).astype(np.float32)
    z_j = np.asarray(jspmv.bucketed_bsr_rmatvec(jop.fwd, jnp.asarray(su),
                                                interpret=True), np.float64)
    if s is not None:
        y_j = s * y_j
    _close(tspmv.row_matvec(fwd, torch.from_numpy(x), st).numpy(), y_j)
    _close(tspmv.row_rmatvec(tr, torch.from_numpy(u), st).numpy(), z_j)
    # and the operator the port builds from the same leaves does the same
    op = tspmv.BlockELLOperator(bell, fwd_scale=st)
    _close(op.matvec(torch.from_numpy(x)).numpy(), y_j)
    _close(op.rmatvec(torch.from_numpy(u)).numpy(), z_j)


def _kernel_walk(rp, v, in_scale, out_scale):
    """The CUDA kernel's walk in numpy float32: lane ``l`` of packed row
    ``r`` sums vectors ``vec_off[r] + l, + lanes, ...`` slot by slot (one
    step at a time, all lanes at once), the lanes of a warp combine through
    the xor tree, the warps of a row in warp order; the epilogue scales and
    writes the original row."""
    rows, ncols = rp.shape
    V, L = tsparse.VEC, rp.lanes
    v = v.astype(np.float32)
    if in_scale is not None:
        v = (in_scale * v).astype(np.float32)
    vec_off = rp.vec_off.numpy().astype(np.int64)
    prod = (rp.vals.to(torch.float32).numpy()
            * v[rp.col_index().numpy()]).reshape(-1, V)
    nv = np.diff(vec_off)
    vec_row = np.repeat(np.arange(rows), nv)
    k = np.arange(vec_off[-1]) - vec_off[vec_row]
    lane = vec_row * L + k % L            # the thread of the row's group
    step = k // L
    acc = np.zeros(rows * L, np.float32)
    for q in range(int(step.max()) + 1 if len(step) else 0):
        at = step == q                    # each lane at most once
        for j in range(V):
            acc[lane[at]] = acc[lane[at]] + prod[at, j]
    acc = acc.reshape(rows, L)
    w = min(L, 32)
    for o in (16, 8, 4, 2, 1):
        if o < w:
            acc = acc + acc[:, np.arange(L) ^ o]
    total = acc[:, 0]
    for warp in range(1, L // 32):
        total = total + acc[:, 32 * warp]
    y = np.full(rows, np.nan, np.float32)
    y[rp.row_map.numpy()] = total
    return y if out_scale is None else out_scale * y


@pytest.mark.parametrize("vecs_per_lane,max_lanes", [(2, 256), (1, 256),
                                                     (16, 2), (1, 1)])
def test_kernel_walk_matches_plain(vecs_per_lane, max_lanes, monkeypatch):
    """A walk of the kernel's lane/row assignment and vector padding, for
    forms whose lane counts run from 1 to 64 (several warps per row), the
    forward form (row scale in the epilogue) and the transposed one (scale
    gathered with the vector), against the plain versions.  Also the
    interleaving: in every step of a row, the lanes' slot j reads the row's
    entries in column order."""
    monkeypatch.setattr(tsparse, "VECS_PER_LANE", vecs_per_lane)
    monkeypatch.setattr(tsparse, "MAX_LANES", max_lanes)
    csr = _random_csr(m=200, n=1000, density=0.3)
    op = tspmv.BlockELLOperator.from_csr(csr, dtype="int8",
                                         with_adjoint=False, device="cpu")
    s = op.fwd_scale.numpy()
    rng = np.random.default_rng(2)
    x = rng.standard_normal(1000).astype(np.float32)
    u = rng.standard_normal(200).astype(np.float32)
    lanes = set()
    for rp, v, ins, outs in ((op.fwd_rows, x, None, s),
                             (op.adj_rows, u, s, None)):
        lanes.add(rp.lanes)
        want = tspmv._row_plain(rp, torch.from_numpy(v),
                                None if ins is None else torch.from_numpy(ins),
                                None if outs is None else
                                torch.from_numpy(outs)).numpy()
        got = _kernel_walk(rp, v, ins, outs)
        assert np.isfinite(got).all()        # every row written once
        _close(got, want)
        # the interleaving: in every step of a row, slot j of the lanes
        # reads consecutive entries of the row's pack order
        vec_row, p = tsparse.pack_positions(rp.vec_off, rp.lanes)
        vec_off = rp.vec_off.numpy()
        cols = rp.col_index().numpy().reshape(-1, tsparse.VEC)
        vals = rp.vals.numpy().reshape(-1, tsparse.VEC)
        p = p.numpy()
        for r in range(rp.shape[0]):
            walked, order = [], []
            for k0 in range(vec_off[r], vec_off[r + 1], rp.lanes):
                step = slice(k0, min(k0 + rp.lanes, vec_off[r + 1]))
                live = vals[step].T.reshape(-1) != 0
                walked.extend(cols[step].T.reshape(-1)[live])
                order.extend(p[step].T.reshape(-1)[live])
            assert order == sorted(order)
            if rp is op.fwd_rows:       # the forward form: column order
                assert walked == sorted(walked)
            else:                       # a source block's rows, in order
                blk = np.asarray(walked) // rp.group
                runs = np.flatnonzero(np.diff(blk)) + 1
                for run in np.split(np.asarray(walked), runs):
                    assert list(run) == sorted(run)
                assert len(set(blk)) == len(runs) + 1
    if max_lanes == 1:
        assert lanes == {1}
    elif vecs_per_lane == 1:
        assert max(lanes) > 32            # a row over several warps


def test_operator_runs_the_row_plain_versions_on_cpu(monkeypatch):
    """``matvec``/``rmatvec`` of a CPU operator go through the redesigned
    K1/K3's plain versions (with and without an adjoint panel, whose form
    ``rmatvec`` then uses) and launch nothing; ``matmat``/``rmatmat`` stay
    on the block-ELL panels."""
    calls = []
    real = tspmv._row_plain

    def spy(rp, *a):
        calls.append(rp)
        return real(rp, *a)

    monkeypatch.setattr(tspmv, "_row_plain", spy)
    csr = _random_csr(m=300, n=200)
    wrappers = (tspmv.row_matvec, tspmv.row_rmatvec, tspmv.bucket_matvec,
                tspmv.bucket_rmatvec)
    before = [w.launches for w in wrappers]
    for with_adjoint in (False, True):
        op = tspmv.BlockELLOperator.from_csr(csr, dtype="int8",
                                             with_adjoint=with_adjoint,
                                             device="cpu")
        calls.clear()
        y = op.matvec(torch.ones(200))
        z = op.rmatvec(torch.ones(300))
        assert calls == [op.fwd_rows, op.adj_rows]
        assert y.shape == (300,) and z.shape == (200,)
        assert op.adj_rows.shape == (200, 300)
        q, s = tspmv._row_quantize_csr(csr)
        held = sp.diags(s.astype(np.float64)) @ q
        _close(y.numpy(), held @ np.ones(200))
        _close(z.numpy(), held.T @ np.ones(300))
    assert [w.launches for w in wrappers] == before


def test_row_wrappers_check_their_arguments():
    csr = _random_csr(m=300, n=200)
    op = tspmv.BlockELLOperator.from_csr(csr, dtype="int8",
                                         with_adjoint=False, device="cpu")
    with pytest.raises(ValueError, match="row_matvec: unsupported device"):
        op.matvec(torch.zeros(200, device="meta"))
    with pytest.raises(ValueError, match="row_rmatvec: unsupported device"):
        op.rmatvec(torch.zeros(300, device="meta"))
    # the checks a CUDA launch makes, reached without a card
    with pytest.raises(ValueError, match="operator needs"):
        tspmv._row_launch("row_matvec", op.fwd_rows, torch.zeros(300), None,
                          None, None)
    with pytest.raises(ValueError, match="scale must have shape"):
        tspmv._row_launch("row_matvec", op.fwd_rows, torch.zeros(200), None,
                          torch.ones(7), None)


def test_empty_rows_and_an_all_zero_matrix():
    """Rows with no entries come out as zeros, and a matrix with no entries
    at all packs into empty forms whose products are zero."""
    csr = _random_csr(m=300, n=200)
    csr = sp.csr_matrix(csr.multiply(
        (np.arange(300) % 3 != 0)[:, None]))        # every third row empty
    op = tspmv.BlockELLOperator.from_csr(csr, dtype="float32",
                                         with_adjoint=False, device="cpu")
    x = np.random.default_rng(3).standard_normal(200).astype(np.float32)
    y = op.matvec(torch.from_numpy(x)).numpy()
    assert (y[::3] == 0).all()
    _close(y, csr @ x)
    zero = tspmv.BlockELLOperator.from_csr(sp.csr_matrix((50, 40)),
                                           dtype="int8", with_adjoint=False,
                                           device="cpu")
    assert zero.fwd_rows.vals.numel() == zero.adj_rows.vals.numel() == 0
    assert not zero.matvec(torch.ones(40)).any()
    assert not zero.rmatvec(torch.ones(50)).any()
