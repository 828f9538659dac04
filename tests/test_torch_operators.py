"""PyTorch port: composed operators, the 1-D test problems, the Gram
Tikhonov solve and the device rules of the coercions, against the JAX
package on the same numpy inputs."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from hybrid_gmres_tpu.krylov import projected as jproj
from hybrid_gmres_tpu.ops import linear_operator as jops
from hybrid_gmres_tpu.problems import ct as jct
from hybrid_gmres_tpu.problems import onedim as jonedim
from hybrid_gmres_tpu.utils import checkpoint as jckpt
from hybrid_gmres_tpu_torch.krylov import projected as tproj
from hybrid_gmres_tpu_torch.ops import linear_operator as tops
from hybrid_gmres_tpu_torch.ops import spmv_cuda as tspmv
from hybrid_gmres_tpu_torch.problems import ct as tct
from hybrid_gmres_tpu_torch.problems import onedim as tonedim
from hybrid_gmres_tpu_torch.utils import checkpoint as tckpt


@pytest.mark.parametrize("name", ["shaw", "heat", "deriv2"])
def test_onedim_problems_match_jax(name):
    """The same numpy assembly: identical float64 arrays; float32 is the
    default dtype; an unknown name, an odd shaw size and a missing card
    raise."""
    jA, jb, jx = jonedim.generate_test_problem(name, 24, dtype=jnp.float64)
    tA, tb, tx = tonedim.generate_test_problem(name, 24, dtype=torch.float64,
                                               device="cpu")
    for j, t in ((jA, tA), (jb, tb), (jx, tx)):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    assert tonedim.generate_test_problem(name, 8, device="cpu")[0].dtype == \
        torch.float32
    with pytest.raises(ValueError, match="Unknown problem"):
        tonedim.generate_test_problem("phillips", 8, device="cpu")
    with pytest.raises(ValueError, match="even"):
        tonedim.shaw(7, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tonedim.generate_test_problem(name, 8)


@pytest.mark.parametrize("kind", ["augmented", "shifted", "product",
                                  "transposed"])
def test_composed_operators_match_jax(kind):
    """matvec / rmatvec / shape / todense of each wrapper (float64; the
    products are single dense matmuls, rtol 1e-14)."""
    rng = np.random.default_rng(0)
    m, n = (9, 6) if kind != "shifted" else (6, 6)
    A, C = rng.standard_normal((m, n)), rng.standard_normal((n, m))
    v, u = rng.standard_normal(n), rng.standard_normal(m)
    jA, tA = jops.DenseOperator(jnp.asarray(A)), tops.DenseOperator(
        torch.from_numpy(A))
    if kind == "augmented":
        jop, top = jops.AugmentedOperator(jA, 0.3), \
            tops.AugmentedOperator(tA, 0.3)
        u = rng.standard_normal(m + n)
        np.testing.assert_array_equal(
            top.augment_rhs(torch.from_numpy(u[:m])).numpy(),
            np.asarray(jop.augment_rhs(jnp.asarray(u[:m]))))
    elif kind == "shifted":
        jop, top = jops.ShiftedOperator(jA, 0.3), tops.ShiftedOperator(tA, 0.3)
    elif kind == "product":
        jop = jops.ProductOperator(jA, jops.DenseOperator(jnp.asarray(C)))
        top = tops.ProductOperator(tA, tops.DenseOperator(
            torch.from_numpy(C)))
        v = rng.standard_normal(m)
    else:
        jop, top = jA.T, tA.T
        u, v = v, u
        np.testing.assert_allclose(
            top.matmat(torch.from_numpy(A)).numpy(), A.T @ A, rtol=1e-14)
    assert tuple(top.shape) == tuple(jop.shape)
    assert top.dtype == torch.float64 and top.device.type == "cpu"
    np.testing.assert_allclose(top.matvec(torch.from_numpy(v)).numpy(),
                               np.asarray(jop.matvec(jnp.asarray(v))),
                               rtol=1e-14, atol=1e-15)
    np.testing.assert_allclose(top.rmatvec(torch.from_numpy(u)).numpy(),
                               np.asarray(jop.rmatvec(jnp.asarray(u))),
                               rtol=1e-14, atol=1e-15)
    np.testing.assert_allclose(top.todense().numpy(),
                               np.asarray(jop.todense()), rtol=1e-14,
                               atol=1e-15)


def test_lam_is_cast_to_the_vector_dtype_not_the_operators():
    """Around an int8 block-ELL operator ``lam`` must survive: the wrapper
    casts it to the vector's dtype (int8(1e-2) would be 0)."""
    csr = sp.random(300, 200, density=0.05, format="csr",
                    random_state=np.random.RandomState(0), dtype=np.float64)
    op = tspmv.BlockELLOperator.from_csr(csr, dtype="int8",
                                         with_adjoint=False, device="cpu")
    assert op.storage_dtype == torch.int8 and op.device.type == "cpu"
    aug = tops.AugmentedOperator(op, 1e-2)
    v = torch.ones(200)
    out = aug.matvec(v)
    np.testing.assert_allclose(out[300:].numpy(), 0.1 * np.ones(200),
                               rtol=1e-6)
    lam_t = torch.tensor(1e-2, dtype=torch.float64)
    np.testing.assert_allclose(
        tops.AugmentedOperator(op, lam_t).matvec(v)[300:].numpy(), 0.1,
        rtol=1e-6)
    back = aug.rmatvec(out)
    want = op.rmatvec(out[:300]) + 0.1 * out[300:]
    np.testing.assert_allclose(back.numpy(), want.numpy(), rtol=1e-6)
    sh = tops.ShiftedOperator(tops.DenseOperator(torch.eye(200)), 1e-2)
    np.testing.assert_allclose(sh.matvec(v).numpy(), 1.01, rtol=1e-6)


def test_as_operator_keeps_devices_and_defaults_to_the_card():
    """An operator or a tensor keeps its device; a numpy array or a list
    goes to the card by default, which raises here without one (no silent
    CPU solve), and to the CPU when asked."""
    from hybrid_gmres_tpu_torch.solvers.gmres import ba_gmres

    A = np.eye(3)
    op = tops.DenseOperator(torch.from_numpy(A))
    assert tops.as_operator(op) is op
    assert tops.as_operator(torch.from_numpy(A)).device.type == "cpu"
    assert tops.as_operator(A, device="cpu").device.type == "cpu"
    assert tops.as_operator([[1.0, 0.0]], device="cpu").shape == (1, 2)
    assert tops.as_vector(torch.ones(3)).device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("the rest checks the error raised without a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tops.as_operator(A)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tops.as_vector(np.ones(3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ba_gmres(A, A, np.ones(3), maxit=2)
    # tensors say where to run: numpy operators follow the right-hand side
    r = ba_gmres(A, A, torch.ones(3, dtype=torch.float64), maxit=2)
    assert r.x.device.type == "cpu"


def test_scalar_tensor_fills_instead_of_copying():
    """A Python number becomes a 0-dim tensor of the asked dtype through a
    fill (on the card a host copy would synchronize once per solver step:
    ``chip_smoke.py`` counts those); tensors are cast, arrays converted."""
    from hybrid_gmres_tpu_torch.utils.device import scalar_tensor

    a = scalar_tensor(1e-2, torch.float32, "cpu")
    assert a.shape == () and a.dtype == torch.float32
    assert float(a) == float(np.float32(1e-2))
    assert scalar_tensor(3, torch.float64, "cpu").item() == 3.0
    t = torch.tensor([1.0, 2.0], dtype=torch.float64)
    assert scalar_tensor(t, torch.float32, "cpu").dtype == torch.float32
    assert scalar_tensor(np.array([1.0, 2.0]), torch.float32,
                         "cpu").tolist() == [1.0, 2.0]
    assert scalar_tensor(np.float64(0.5), torch.float32, "cpu").item() == 0.5


def test_todense_builds_on_the_operators_device():
    """``todense`` of a CPU operator works for a kernel-backed operator too
    (its identity is made on ``op.device``, here checked by handing the
    base implementation an operator that rejects any other device)."""
    csr = sp.random(70, 50, density=0.1, format="csr",
                    random_state=np.random.RandomState(1), dtype=np.float64)
    op = tspmv.BlockELLOperator.from_csr(csr, with_adjoint=False,
                                         device="cpu")
    np.testing.assert_allclose(op.todense().numpy(), csr.toarray(),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(op.T.todense().numpy(), csr.toarray().T,
                               rtol=1e-6, atol=1e-7)

    class OnMeta(tops.LinearOperator):
        shape, dtype, device = (2, 2), torch.float32, torch.device("meta")

        def matmat(self, X):
            assert X.device.type == "meta"
            return X

    assert OnMeta().todense().device.type == "meta"


@pytest.mark.parametrize("kdim", [1, 3, 6])
def test_projected_gram_tikhonov_solve_matches_jax(kdim):
    """Padded (maxit=6) Gram system, Python and tensor ``kdim``/``lam``, and
    a batch over lambda (the JAX package's vmap written out)."""
    rng = np.random.default_rng(kdim)
    M = rng.standard_normal((8, 6))
    M[:, kdim:] = 0.0
    G, rhs = M.T @ M, M.T @ rng.standard_normal(8)
    want = np.asarray(jproj.projected_gram_tikhonov_solve(
        jnp.asarray(G), jnp.asarray(rhs), 1e-2, kdim))
    tG, trhs = torch.from_numpy(G), torch.from_numpy(rhs)
    for kd, lam in ((kdim, 1e-2), (torch.tensor(kdim),
                                   torch.tensor(1e-2, dtype=torch.float64))):
        got = tproj.projected_gram_tikhonov_solve(tG, trhs, lam, kd).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-14)
        assert (got[kdim:] == 0).all()
    lams = torch.tensor([1e-2, 1e-1], dtype=torch.float64)
    both = tproj.projected_gram_tikhonov_solve(
        tG.expand(2, -1, -1), trhs.expand(2, -1), lams, kdim).numpy()
    np.testing.assert_allclose(both[0], want, rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(both[1], np.asarray(
        jproj.projected_gram_tikhonov_solve(jnp.asarray(G), jnp.asarray(rhs),
                                            1e-1, kdim)), rtol=1e-10,
        atol=1e-14)


@pytest.mark.parametrize("R", [2, 3, 8, 16, 33])
def test_vector_lam_fingerprint_crosses_the_packages(R, tmp_path):
    """A state saved by the JAX package with an (R,) ``lam`` checks cleanly
    in the port, and the port's in JAX... as far as float32 allows: XLA and
    numpy round the checksum's cosines and order its sum differently, so the
    port holds the vector slot to the rounding bound of that sum; a vector
    with one entry 1% off raises, a permuted one raises, and the slot is a
    host value whatever tensor it was made from."""
    rng = np.random.default_rng(R)
    lam = rng.uniform(1e-4, 1e-1, R)
    x0 = rng.standard_normal(12)
    jfp = jckpt.resume_fingerprint(jnp.asarray(x0), jnp.asarray(lam))
    tfp = tckpt.resume_fingerprint(torch.from_numpy(x0), lam)
    np.testing.assert_allclose(tfp.numpy(), np.asarray(jfp), rtol=2e-6)
    np.testing.assert_array_equal(
        tfp.numpy()[1:],
        tckpt.resume_fingerprint(None, torch.from_numpy(lam)).numpy()[1:])

    class State:
        fp = torch.from_numpy(np.array(jfp))

    tckpt.check_fingerprint(State, torch.from_numpy(x0), lam)
    tckpt.check_fingerprint(State, torch.from_numpy(x0),
                            torch.from_numpy(lam))
    off = lam.copy()
    off[R // 2] *= 1.01
    for other in (off, lam[::-1].copy(), lam[:-1] if R > 2 else lam * 2,
                  float(lam[0]), None, "gcv"):
        with pytest.raises(ValueError, match="fingerprint"):
            tckpt.check_fingerprint(State, torch.from_numpy(x0), other)
    with pytest.raises(ValueError, match="fingerprint"):
        tckpt.check_fingerprint(State, torch.from_numpy(x0 + 1.0), lam)
    # scalars stay exact in both directions
    s = tckpt.resume_fingerprint(None, 1e-2, tag="full").numpy()
    np.testing.assert_array_equal(s, np.asarray(
        jckpt.resume_fingerprint(None, 1e-2, tag="full")))


@pytest.mark.parametrize("with_adjoint", [False, True])
def test_ct_gpu_operators_with_adjoint_matches_jax(with_adjoint):
    """``ct_gpu_operators(with_adjoint=...)``: the default builds forward
    panels only, as the JAX package's; ``True`` packs the adjoint panels,
    byte-identical to the JAX ones, and ``rmatvec`` then agrees with the
    forward-panel transposed product (another summation order, rtol 1e-5)."""
    jp = jct.ct_mismatched(n=16, n_angles=24, n_det=24, dense=False)
    tp = tct.ct_mismatched(n=16, n_angles=24, n_det=24)
    jA, jB = jct.ct_tpu_operators(jp, dtype=jnp.int8,
                                  with_adjoint=with_adjoint)[:2]
    tA, tB = tct.ct_gpu_operators(tp, dtype="int8", device="cpu",
                                  with_adjoint=with_adjoint)[:2]
    assert tct.ct_gpu_operators.__defaults__[-1] is False
    for jo, to in ((jA, tA), (jB, tB)):
        assert (to.adj is None) == (jo.adj is None) == (not with_adjoint)
        if with_adjoint:
            for (bj, cj), (bt, ct) in zip(jo.adj.buckets, to.adj.buckets):
                np.testing.assert_array_equal(np.asarray(bj), bt.numpy())
                np.testing.assert_array_equal(np.asarray(cj), ct.numpy())
            np.testing.assert_array_equal(np.asarray(jo.adj.inv_perm),
                                          to.adj.inv_perm.numpy())
            assert to.adj_scale is None and jo.adj_scale is None
    u = torch.from_numpy(np.random.default_rng(0).standard_normal(
        tA.shape[0]).astype(np.float32))
    fwd_only = tspmv.bucket_rmatvec_plain(tA.fwd, u, tA.fwd_scale)
    np.testing.assert_allclose(tA.rmatvec(u).numpy(), fwd_only.numpy(),
                               rtol=0, atol=1e-5 * float(fwd_only.abs().max()))


@pytest.mark.parametrize("with_adjoint", [False, True])
def test_panels_move_between_devices(with_adjoint):
    """``BucketedBlockELL.to`` copies every tensor of a panel and re-cuts
    its bucket views from the copies (to the meta device here, which keeps
    shapes and dtypes); ``panels_on_device`` of a CPU operator keeps its
    panels where they are, and the operator's products read its forms."""
    rng = np.random.default_rng(5)
    # 2400 rows (300 block rows: the packer keeps >= 128 a bucket) from
    # 0.1% to 5% full, so block rows of many counts and two buckets
    keep = rng.random((2400, 700)) < np.linspace(1e-3, 0.05, 2400)[:, None]
    csr = sp.csr_matrix(rng.standard_normal((2400, 700)) * keep)
    op = tspmv.BlockELLOperator.from_csr(
        csr, dtype="int8", n_buckets=3, with_adjoint=with_adjoint,
        device="cpu")
    bell = op.fwd
    assert len(bell.buckets) > 1 and bell.to("cpu") is bell
    meta = bell.to("meta")
    assert meta.device.type == "meta" and meta.shape == bell.shape
    for (b, c), (mb, mc) in zip(bell.buckets, meta.buckets):
        assert (mb.shape, mc.shape) == (b.shape, c.shape)
        assert mb.device.type == mc.device.type == "meta"
    for name in ("inv_perm", "pos_off", "col_blk", "seg_off", "col_seg"):
        got, want = getattr(meta, name), getattr(bell, name)
        assert got.device.type == "meta" and got.shape == want.shape
        assert got.dtype == want.dtype
    assert meta.seg_len == bell.seg_len and meta.ncb == bell.ncb
    assert op.device == op.fwd_rows.device == torch.device("cpu")
    x = torch.as_tensor(rng.standard_normal(700))
    y = op.matvec(x)
    with op.panels_on_device() as same:
        assert same is op and op.fwd is bell
        # both sum in float32, in other orders
        np.testing.assert_allclose(
            tspmv.bucket_matvec(op.fwd, x, op.fwd_scale).numpy(), y.numpy(),
            rtol=0, atol=1e-5 * float(y.abs().max()))
    assert op.fwd is bell and (op.adj is None) == (not with_adjoint)
