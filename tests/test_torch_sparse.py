"""PyTorch port: block-ELL packer and the K1-K4 module against the JAX package.

The same numpy inputs go through both packages.  The JAX operators run their
Pallas kernels in interpret mode on the CPU; the port's wrapper takes its
plain PyTorch version for CPU tensors.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from hybrid_gmres_tpu.ops import sparse as jsparse
from hybrid_gmres_tpu.ops import spmv_pallas as jspmv
from hybrid_gmres_tpu_torch.ops import sparse as tsparse
from hybrid_gmres_tpu_torch.ops import spmv_cuda as tspmv
from hybrid_gmres_tpu_torch.utils.convert import operator_from_numpy

# K1 parity tolerance: both sides multiply the same stored block values by
# the same float32 x and accumulate in float32; only the summation order
# differs, so ||y_port - y_jax||_inf <= 1e-5 ||y_jax||_inf.
RTOL = 1e-5


def _random_csr(m=2100, n=700, density=0.02, seed=0):
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


def _assert_panels_equal(jbell, tbell):
    assert len(jbell.buckets) == len(tbell.buckets)
    for (jb, jc), (tb, tc) in zip(jbell.buckets, tbell.buckets):
        assert tb.dtype == torch.from_numpy(np.array(jb)).dtype
        np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
        np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_array_equal(np.asarray(jbell.inv_perm),
                                  tbell.inv_perm.numpy())
    assert jbell.ncb == tbell.ncb and tuple(jbell.shape) == tbell.shape


def _leaves(bell):
    """The JAX container's leaves as numpy arrays."""
    return dict(buckets=[(np.asarray(b), np.asarray(c))
                         for b, c in bell.buckets],
                inv_perm=np.asarray(bell.inv_perm), shape=bell.shape,
                ncb=bell.ncb, packed4=bell.packed4)


def _convert(jop):
    return operator_from_numpy(
        _leaves(jop.fwd), None if jop.adj is None else _leaves(jop.adj),
        fwd_scale=None if jop.fwd_scale is None else np.asarray(jop.fwd_scale),
        adj_scale=None if jop.adj_scale is None else np.asarray(jop.adj_scale),
        fro_sq=np.asarray(jop.fro_sq), device="cpu")


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float64)
    err = np.max(np.abs(np.asarray(got, np.float64) - want))
    assert err <= rtol * np.max(np.abs(want)), (err, np.max(np.abs(want)))


@pytest.mark.parametrize("source", ["random", "ct16_A", "ct16_B"])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_packer_matches_jax(source, dtype):
    if source == "random":
        csr, block = _random_csr(), (8, 128)
    else:
        A, B = _ct16_csr_pair()
        csr, block = (A, (32, 128)) if source == "ct16_A" else (B, (8, 128))
    np_dt = np.float32
    if dtype == "int8":
        jq, js = jspmv._row_quantize_csr(csr)
        tq, ts = tspmv._row_quantize_csr(csr)
        np.testing.assert_array_equal(js, ts)
        np.testing.assert_array_equal(jq.toarray(), tq.toarray())
        csr, np_dt = tq, np.int8
    for n_buckets, row_group in ((8, 8), (4, 1)):
        kw = dict(block=block, dtype=np_dt, n_buckets=n_buckets,
                  row_group=row_group)
        _assert_panels_equal(jsparse.bucketed_block_ell_from_csr(csr, **kw),
                             tsparse.bucketed_block_ell_from_csr(
                                 csr, device="cpu", **kw))


def test_flat_layout_is_what_the_kernel_walks():
    """Emulate the CUDA kernel's indexing in numpy (one block-row position
    at a time: pos_off/pos_cnt into the flat arrays, x read unpadded with
    columns >= n masked, output rows of pos_row, rows >= m dropped) and check
    it against the plain version."""
    csr_q, s = tspmv._row_quantize_csr(_random_csr(m=1001, n=650))
    bell = tsparse.bucketed_block_ell_from_csr(csr_q, block=(8, 128),
                                               dtype=np.int8, n_buckets=4,
                                               row_group=1, device="cpu")
    op = tspmv.BlockELLOperator(bell, fwd_scale=torch.from_numpy(s))
    assert len(bell.buckets) > 1
    for blocks, _ in bell.buckets:   # bucket tensors are views of the flat
        assert blocks.untyped_storage().data_ptr() == \
            bell.blocks_flat.untyped_storage().data_ptr()
    br, bc = bell.block_shape
    m, n = bell.shape
    x = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    blocks = bell.blocks_flat.numpy().astype(np.float32)
    bcols = bell.bcols_flat.numpy()
    scale = op.fwd_scale.numpy()
    y = np.full(m, np.nan, np.float32)
    for p in range(bell.pos_row.shape[0]):
        row = int(bell.pos_row[p])
        if row < 0:
            continue
        off, cnt = int(bell.pos_off[p]), int(bell.pos_cnt[p])
        cols = bcols[off:off + cnt, None] * bc + np.arange(bc)
        xv = np.where(cols < n, x[np.minimum(cols, n - 1)], 0.0)
        acc = np.einsum("jrc,jc->r", blocks[off:off + cnt], xv)
        rows = row * br + np.arange(br)
        keep = rows < m
        y[rows[keep]] = scale[rows[keep]] * acc[keep]
    assert np.isfinite(y).all()            # every output row written once
    _close(y, op.matvec(torch.from_numpy(x)).numpy())
    # pos_cnt skips only zero padding: counting every slot gives the same y
    assert int(bell.pos_cnt.sum()) < bell.bcols_flat.numel()


@pytest.mark.parametrize("block", [(32, 128), (8, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_k1_matches_jax_interpret_kernel(block, dtype):
    """m=2100 and n=700 are not multiples of the block shape; row_group=2
    gives several buckets at this size."""
    csr = _random_csr()
    jop = jspmv.PallasBSROperator.from_csr(
        csr, block=block, dtype=jnp.dtype(dtype), n_buckets=4,
        with_adjoint=True, interpret=True, row_group=2)
    assert len(jop.fwd.buckets) > 1
    op = _convert(jop)
    assert op.dtype == (torch.float32 if dtype != "bfloat16"
                        else torch.bfloat16)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(csr.shape[1]).astype(np.float32)
    u = rng.standard_normal(csr.shape[0]).astype(np.float32)
    _close(op.matvec(torch.from_numpy(x)).numpy(),
           jop.matvec(jnp.asarray(x)))
    # rmatvec through the adjoint panel: K1 again
    _close(op.rmatvec(torch.from_numpy(u)).numpy(),
           jop.rmatvec(jnp.asarray(u)))
    np.testing.assert_allclose(float(op.fro_sq), float(jop.fro_sq), rtol=0)


def test_k1_float64_vectors_match_jax():
    """Solver dtype float64 (the CPU parity regime): both packages cast x to
    float32 for the panel product, scale in float32, and return float64."""
    csr = _random_csr(m=700, n=300)
    jop = jspmv.PallasBSROperator.from_csr(csr, dtype=jnp.int8, n_buckets=2,
                                           with_adjoint=False, interpret=True,
                                           row_group=1)
    op = _convert(jop)
    x = np.random.default_rng(2).standard_normal(300)
    got = op.matvec(torch.from_numpy(x))
    assert got.dtype == torch.float64
    _close(got.numpy(), jop.matvec(jnp.asarray(x)))


def test_rmatvec_without_adjoint_panel_plain_matches_jax_k3():
    """On CPU the port's plain K3 (transpose from the forward panel) agrees
    with the JAX interpret-mode K3."""
    csr = _random_csr(m=900, n=500)
    for dtype in (jnp.float32, jnp.int8):
        jop = jspmv.PallasBSROperator.from_csr(
            csr, dtype=dtype, n_buckets=4, with_adjoint=False,
            interpret=True, row_group=1)
        op = _convert(jop)
        u = np.random.default_rng(3).standard_normal(900).astype(np.float32)
        _close(op.rmatvec(torch.from_numpy(u)).numpy(),
               jop.rmatvec(jnp.asarray(u)))


def test_unported_kernels_raise_on_a_device_tensor():
    """All four kernels are ported, each also in its redesign on the
    row-packed form that the operator's products run, and every wrapper
    takes only CPU and CUDA tensors: they raise on any other device (the
    meta device stands in here) and never fall back to their plain
    versions.  int4 panels are ported too: their operator builds, and its
    wrappers raise on another device the same way."""
    op = tspmv.BlockELLOperator.from_csr(_random_csr(m=300, n=200),
                                         with_adjoint=False, device="cpu")
    for name, call in (
            ("row_rmatvec", lambda: op.rmatvec(torch.zeros(300,
                                                           device="meta"))),
            ("row_matvec", lambda: op.matvec(torch.zeros(200,
                                                         device="meta"))),
            ("bucket_rmatvec", lambda: tspmv.bucket_rmatvec(
                op.fwd, torch.zeros(300, device="meta"))),
            ("row_matmat", lambda: op.matmat(torch.zeros((200, 2),
                                                         device="meta"))),
            ("row_matmat", lambda: op.matmat_into(
                torch.zeros((200, 2), device="meta"),
                torch.zeros((300, 2), device="meta"))),
            ("row_rmatmat", lambda: op.rmatmat(torch.zeros(
                (300, 2), device="meta"))),
            ("bucket_matmat", lambda: tspmv.bucket_matmat(
                op.fwd, torch.zeros((200, 2), device="meta"))),
            ("bucket_matvec", lambda: tspmv.bucket_matvec(
                op.fwd, torch.zeros(200, device="meta"))),
            ("bucket_rmatmat", lambda: tspmv.bucket_rmatmat(
                op.fwd, torch.zeros((300, 2), device="meta")))):
        with pytest.raises(ValueError, match=f"{name}: unsupported device"):
            call()
    op4 = tspmv.BlockELLOperator.from_csr(_random_csr(m=300, n=200),
                                          dtype="int4", with_adjoint=False,
                                          device="cpu")
    assert op4.fwd_rows.packed4 and op4.storage_dtype == torch.int4
    for name, call in (
            ("row_matvec", lambda: op4.matvec(torch.zeros(200,
                                                          device="meta"))),
            ("row_rmatmat", lambda: op4.rmatmat(torch.zeros(
                (300, 2), device="meta")))):
        with pytest.raises(ValueError, match=f"{name}: unsupported device"):
            call()
    # the CPU plain paths still work
    X = torch.randn(200, 2)
    np.testing.assert_allclose(
        op.matmat(X).numpy(),
        torch.stack([op.matvec(X[:, 0]), op.matvec(X[:, 1])], 1).numpy(),
        rtol=1e-5, atol=1e-6)


def test_constructors_default_to_the_card_and_never_fall_back():
    """Without a CUDA device the default ``device="cuda"`` raises a clear
    error in every public constructor; the convert helpers need ``device``
    spelled out."""
    from hybrid_gmres_tpu_torch.utils import convert
    from hybrid_gmres_tpu_torch.utils.checkpoint import load_state

    if torch.cuda.is_available():
        pytest.skip("this test checks the error raised without a CUDA device")
    csr = _random_csr(m=300, n=200)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tspmv.BlockELLOperator.from_csr(csr)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsparse.bucketed_block_ell_from_csr(csr)
    bell = tsparse.bucketed_block_ell_from_csr(csr, device="cpu")
    leaves = dict(buckets=[(b.numpy(), c.numpy()) for b, c in bell.buckets],
                  inv_perm=bell.inv_perm.numpy(), shape=bell.shape,
                  ncb=bell.ncb)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsparse.BucketedBlockELL.from_numpy(**leaves)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_state("unused.npz")
    for fn, args in ((convert.bell_from_numpy, leaves.values()),
                     (convert.operator_from_numpy, (leaves,)),
                     (convert.dense_from_numpy, (np.eye(2),))):
        with pytest.raises(TypeError, match="device"):
            fn(*args)


@pytest.mark.parametrize("block", [(32, 128), (8, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_k2_plain_matches_jax_interpret_kernel(block, dtype):
    """K2's plain version against the JAX multi-RHS kernel in interpret
    mode, forward and through the adjoint panel, and against K1's plain
    version column by column (rtol 1e-5 of the largest entry: float32
    accumulation in another order).  R=5 is not a multiple of anything."""
    csr = _random_csr()
    jop = jspmv.PallasBSROperator.from_csr(
        csr, block=block, dtype=jnp.dtype(dtype), n_buckets=4,
        with_adjoint=True, interpret=True, row_group=2)
    op = _convert(jop)
    rng = np.random.default_rng(5)
    X = rng.standard_normal((csr.shape[1], 5)).astype(np.float32)
    U = rng.standard_normal((csr.shape[0], 5)).astype(np.float32)
    Y = op.matmat(torch.from_numpy(X))
    Z = op.rmatmat(torch.from_numpy(U))
    assert Y.shape == (csr.shape[0], 5) and Z.shape == (csr.shape[1], 5)
    _close(Y.numpy(), jop.matmat(jnp.asarray(X)))
    _close(Z.numpy(), jop.rmatmat(jnp.asarray(U)))
    for j in range(5):
        _close(Y[:, j].numpy(), op.matvec(torch.from_numpy(X[:, j])).numpy())
        _close(Z[:, j].numpy(), op.rmatvec(torch.from_numpy(U[:, j])).numpy())
    # a transposed view of an (R, n) array, the batched solver's layout
    Xt = torch.from_numpy(np.ascontiguousarray(X.T)).T
    np.testing.assert_array_equal(op.matmat(Xt).numpy(), Y.numpy())


def test_k2_float64_and_no_adjoint_panel_match_jax():
    """Float64 columns (the CPU parity regime) go through the float32 panel
    product and come back float64; without an adjoint panel ``rmatmat``
    uses the plain transposed product on the CPU (K4's path in JAX)."""
    csr = _random_csr(m=700, n=300)
    jop = jspmv.PallasBSROperator.from_csr(csr, dtype=jnp.int8, n_buckets=2,
                                           with_adjoint=False, interpret=True,
                                           row_group=1)
    op = _convert(jop)
    rng = np.random.default_rng(6)
    X, U = rng.standard_normal((300, 3)), rng.standard_normal((700, 3))
    got = op.matmat(torch.from_numpy(X))
    assert got.dtype == torch.float64
    _close(got.numpy(), jop.matmat(jnp.asarray(X)))
    _close(op.rmatmat(torch.from_numpy(U)).numpy(),
           jop.rmatmat(jnp.asarray(U)))


def test_k2_layout_walk_matches_plain():
    """Emulate the K2 kernel's indexing in numpy (a position at a time, X
    read through its strides with columns >= n masked, tiles of 8 columns
    with a ragged last tile, rows of pos_row, rows >= m dropped) and check
    it against the plain version, for a row-major and a transposed X."""
    csr_q, s = tspmv._row_quantize_csr(_random_csr(m=1001, n=650))
    bell = tsparse.bucketed_block_ell_from_csr(
        csr_q, block=(32, 128), dtype=np.int8, n_buckets=4, row_group=1,
        device="cpu")
    br, bc = bell.block_shape
    m, n = bell.shape
    R = 11
    X = np.random.default_rng(7).standard_normal((n, R)).astype(np.float32)
    want = tspmv.bucket_matmat_plain(bell, torch.from_numpy(X),
                                     torch.from_numpy(s)).numpy()
    blocks = bell.blocks_flat.numpy().astype(np.float32)
    bcols = bell.bcols_flat.numpy()
    for xs in (X, np.ascontiguousarray(X.T).T):
        ldn, ldr = (st // 4 for st in xs.strides)
        buf = (xs.base if xs.base is not None else xs).reshape(-1)
        Y = np.full((m, R), np.nan, np.float32)
        for r0 in range(0, R, 8):
            rc = min(8, R - r0)
            for p in range(bell.pos_row.shape[0]):
                row = int(bell.pos_row[p])
                if row < 0:
                    continue
                off, cnt = int(bell.pos_off[p]), int(bell.pos_cnt[p])
                cols = bcols[off:off + cnt, None] * bc + np.arange(bc)
                idx = (np.minimum(cols, n - 1)[..., None] * ldn
                       + (r0 + np.arange(rc)) * ldr)
                xv = np.where((cols < n)[..., None], buf[idx], 0.0)
                acc = np.einsum("jic,jcr->ir", blocks[off:off + cnt], xv)
                rows = row * br + np.arange(br)
                keep = rows < m
                Y[rows[keep], r0:r0 + rc] = \
                    s[rows[keep], None] * acc[keep]
        assert np.isfinite(Y).all()        # every entry written once
        _close(Y, want)


def test_cpu_path_never_touches_the_kernel_library(monkeypatch):
    from hybrid_gmres_tpu_torch.ops import _build
    from hybrid_gmres_tpu_torch.solvers.batched import ba_gmres_batched
    from hybrid_gmres_tpu_torch.solvers.gkb_batched import lsqr_batched
    from hybrid_gmres_tpu_torch.solvers.gmres import ba_gmres
    from hybrid_gmres_tpu_torch.solvers.lsqr import lsqr

    def boom(*a, **k):
        raise AssertionError("CPU path loaded the CUDA kernel library")

    monkeypatch.setattr(_build, "load_library", boom)
    csr = _random_csr(m=400, n=300)
    A = tspmv.BlockELLOperator.from_csr(csr, dtype="int8",
                                        with_adjoint=False, device="cpu")
    B = tspmv.BlockELLOperator.from_csr(csr.T.tocsr(), dtype="int8",
                                        with_adjoint=False, device="cpu")
    kernels = (tspmv.bucket_matvec, tspmv.bucket_matmat,
               tspmv.bucket_rmatvec, tspmv.bucket_rmatmat, tspmv.row_matvec,
               tspmv.row_rmatvec, tspmv.row_matmat, tspmv.row_rmatmat,
               tspmv.wide_matmat)
    before = [k.launches for k in kernels]
    rng = np.random.default_rng(4)
    b = torch.from_numpy(rng.standard_normal(400))
    r = ba_gmres(A, B, b.float(), tol=0.0, maxit=5, lam=1e-2,
                 residual="fused")
    assert torch.isfinite(r.res_hist).all()
    rb = ba_gmres_batched(A, B, torch.from_numpy(
        rng.standard_normal((400, 3))).float(), tol=0.0, maxit=5, lam=1e-2)
    assert torch.isfinite(rb.res_hist).all()
    # the GKB solvers reach the redesigned K3's and K4's wrappers (forward
    # panels only)
    rg = lsqr(A, b.float(), tol=0.0, maxit=5)
    rgb = lsqr_batched(A, torch.from_numpy(
        rng.standard_normal((400, 3))).float(), maxit=5)
    assert torch.isfinite(rg.res_hist).all()
    assert torch.isfinite(rgb.res_hist).all()
    # K2w's wrapper on a CPU tensor takes its plain version; the operator's
    # wide products keep the row form's and build no tile form
    Xw = torch.from_numpy(rng.standard_normal((300, 20))).float()
    tp = tsparse.tile_packed_from_bell(A.fwd)
    assert torch.isfinite(tspmv.wide_matmat(tp, Xw, A.fwd_scale)).all()
    assert torch.isfinite(A.matmat(Xw)).all() and A._tiles is None
    assert [k.launches for k in kernels] == before
    assert not _build._LIBS
    # nor does a CPU form hold a window form (the window kernel's, made
    # with a form on the card)
    for op in (A, B):
        assert op.fwd_rows.wins is None and op.adj_rows.wins is None


def _brute_force_index(bell):
    """Block column -> [(flat block index, original block-row), ...] by
    walking every slot of every position in flat order."""
    bcols = bell.bcols_flat.numpy()
    by_col = {c: [] for c in range(bell.ncb)}
    for p in range(bell.pos_row.shape[0]):
        row = int(bell.pos_row[p])
        if row < 0:
            continue
        off = int(bell.pos_off[p])
        for j in range(int(bell.pos_cnt[p])):
            by_col[int(bcols[off + j])].append((off + j, row))
    return by_col


@pytest.mark.parametrize("seg_target", [1024, 16])
@pytest.mark.parametrize("block", [(32, 128), (8, 128)])
def test_transposed_index_is_a_transpose_of_bcols(block, seg_target,
                                                  monkeypatch):
    """The pack-time block-column index against a brute-force transpose of
    ``bcols``: every live block listed once, under its own column, in
    ascending flat order, with its block-row; segments tile each column's
    list in order, none longer than ``seg_len`` or spanning two columns.
    ``seg_target=16`` forces segments of several blocks at this size."""
    monkeypatch.setattr(tsparse, "SEG_TARGET", seg_target)
    bell = tsparse.bucketed_block_ell_from_csr(
        _random_csr(m=1001, n=650), block=block, n_buckets=4, row_group=1,
        device="cpu")
    want = _brute_force_index(bell)
    col_blk, col_row = bell.col_blk.numpy(), bell.col_row.numpy()
    seg_off, col_seg = bell.seg_off.numpy(), bell.col_seg.numpy()
    assert col_blk.dtype == col_row.dtype == seg_off.dtype == np.int32
    assert len(col_blk) == int(bell.pos_cnt[bell.pos_row >= 0].sum())
    assert col_seg[0] == 0 and col_seg[-1] == len(seg_off) - 1
    assert seg_off[0] == 0 and seg_off[-1] == len(col_blk)
    assert (np.diff(seg_off) > 0).all()
    assert np.diff(seg_off).max() == bell.seg_len <= tsparse.SEG_MAX
    if seg_target == 16:
        assert bell.seg_len > 1
    for c in range(bell.ncb):
        lo, hi = seg_off[col_seg[c]], seg_off[col_seg[c + 1]]
        assert list(zip(col_blk[lo:hi], col_row[lo:hi])) == want[c]
        # whole segments except the column's last
        assert (np.diff(seg_off[col_seg[c]:col_seg[c + 1] + 1])[:-1]
                == bell.seg_len).all()


@pytest.mark.parametrize("block,dtype,n_buckets,row_group", [
    ((32, 128), "float32", 4, 2), ((32, 128), "bfloat16", 4, 2),
    ((32, 128), "int8", 4, 2), ((8, 128), "float32", 4, 2),
    ((8, 128), "bfloat16", 4, 2), ((8, 128), "int8", 4, 2),
    ((32, 128), "int8", 1, 1), ((8, 128), "float32", 8, 1)])
def test_k3_k4_plain_match_jax_interpret_kernels(block, dtype, n_buckets,
                                                 row_group):
    """K3's and K4's plain versions against the JAX transposed kernels in
    interpret mode on forward panels only (ragged m=700, n=500; one to
    eight buckets), against ``A^T u`` from scipy with the matrix the panel
    holds, and K4's columns against K3 (rtol 1e-5 of the largest entry: the
    same stored values, float32 accumulation in another order).  R=5 fills
    no tile."""
    csr = _random_csr(m=700, n=500)
    jop = jspmv.PallasBSROperator.from_csr(
        csr, block=block, dtype=jnp.dtype(dtype), n_buckets=n_buckets,
        with_adjoint=False, interpret=True, row_group=row_group)
    op = _convert(jop)
    assert op.adj is None
    rng = np.random.default_rng(8)
    U = rng.standard_normal((csr.shape[0], 5)).astype(np.float32)
    z = op.rmatvec(torch.from_numpy(U[:, 0]))
    Z = op.rmatmat(torch.from_numpy(U))
    assert z.shape == (500,) and Z.shape == (500, 5)
    _close(z.numpy(), jop.rmatvec(jnp.asarray(U[:, 0])))
    _close(Z.numpy(), jop.rmatmat(jnp.asarray(U)))
    for j in range(5):
        _close(Z[:, j].numpy(), op.rmatvec(torch.from_numpy(U[:, j])).numpy())
    # the column-major layout of the batched solvers, and float64 columns
    Ut = torch.from_numpy(np.ascontiguousarray(U.T)).T
    np.testing.assert_array_equal(op.rmatmat(Ut).numpy(), Z.numpy())
    Z64 = op.rmatmat(torch.from_numpy(U.astype(np.float64)))
    assert Z64.dtype == torch.float64
    _close(Z64.numpy(), Z.numpy())
    # the matrix the panel holds: diag(s) Q for int8, the rounded values
    # for bf16 (8 significant bits: 2^-8 of sum |a u|), A itself for f32
    if dtype == "int8":
        q, s = tspmv._row_quantize_csr(csr)
        held = sp.diags(s.astype(np.float64)) @ q
        _close(Z.numpy(), held.T @ U.astype(np.float64))
    elif dtype == "float32":
        _close(Z.numpy(), csr.T @ U.astype(np.float64))
    else:
        bound = 2.0 ** -8 * (abs(csr).T @ np.abs(U).astype(np.float64))
        assert (np.abs(Z.numpy() - csr.T @ U.astype(np.float64))
                <= bound + 1e-6).all()


@pytest.mark.parametrize("block", [(32, 128), (8, 128)])
def test_k3_k4_index_walk_matches_plain(block, monkeypatch):
    """Emulate the transposed kernels' indexing in numpy (a segment at a
    time: the staged ``scale * u`` of its block-rows with rows >= m read as
    zero, U read through its strides in tiles of 8 columns, the blocks in
    list order; then the column's partials summed in segment order and rows
    >= n dropped) and check it against the plain versions."""
    monkeypatch.setattr(tsparse, "SEG_TARGET", 16)
    csr_q, s = tspmv._row_quantize_csr(_random_csr(m=1001, n=650))
    bell = tsparse.bucketed_block_ell_from_csr(
        csr_q, block=block, dtype=np.int8, n_buckets=4, row_group=1,
        device="cpu")
    br, bc = bell.block_shape
    m, n = bell.shape
    R = 11
    U = np.random.default_rng(9).standard_normal((m, R)).astype(np.float32)
    want = tspmv.bucket_rmatmat_plain(bell, torch.from_numpy(U),
                                      torch.from_numpy(s)).numpy()
    blocks = bell.blocks_flat.numpy().astype(np.float32)
    col_blk, col_row = bell.col_blk.numpy(), bell.col_row.numpy()
    seg_off, col_seg = bell.seg_off.numpy(), bell.col_seg.numpy()
    n_seg = len(seg_off) - 1
    for us in (U, np.ascontiguousarray(U.T).T):
        ldm, ldr = (st // 4 for st in us.strides)
        buf = (us.base if us.base is not None else us).reshape(-1)
        part = np.full((n_seg, R, bc), np.nan, np.float32)
        for r0 in range(0, R, 8):
            rc = min(8, R - r0)
            for sg in range(n_seg):
                ent = np.arange(seg_off[sg], seg_off[sg + 1])
                rows = col_row[ent][:, None] * br + np.arange(br)
                idx = (np.minimum(rows, m - 1)[..., None] * ldm
                       + (r0 + np.arange(rc)) * ldr)
                su = np.where((rows < m)[..., None],
                              buf[idx] * s[np.minimum(rows, m - 1)][..., None],
                              0.0)                       # (ent, br, rc)
                part[sg, r0:r0 + rc] = np.einsum(
                    "erc,erj->jc", blocks[col_blk[ent]], su)
        assert np.isfinite(part).all()        # every partial written once
        Y = np.zeros((bell.ncb * bc, R), np.float32)
        for c in range(bell.ncb):
            Y[c * bc:(c + 1) * bc] = part[col_seg[c]:col_seg[c + 1]].sum(
                axis=0).T
        _close(Y[:n], want)
        _close(Y[:n, 0], tspmv.bucket_rmatvec_plain(
            bell, torch.from_numpy(U[:, 0]), torch.from_numpy(s)).numpy())
