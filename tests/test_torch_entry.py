"""PyTorch port: the CT operators at their default storage type (bfloat16)
and in float32, the ``entry()`` twin of ``__graft_entry__.py``, and the
last public names (the ELL and block-ELL reference formats,
``local_shard_info``, ``dispatch_floor_seconds``), each against the JAX
package on the same seeded inputs."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from hybrid_gmres_tpu.ops import sparse as jsparse
from hybrid_gmres_tpu.problems import ct as jct
from hybrid_gmres_tpu.solvers.batched import ba_gmres_batched as jbb
from hybrid_gmres_tpu.solvers.gmres import ba_gmres as jba
from hybrid_gmres_tpu_torch.ops import sparse as tsparse
from hybrid_gmres_tpu_torch.problems import ct as tct
from hybrid_gmres_tpu_torch.problems.noise import add_noise
from hybrid_gmres_tpu_torch.solvers.batched import ba_gmres_batched as tbb
from hybrid_gmres_tpu_torch.solvers.gmres import ba_gmres as tba

JDTYPES = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}
TDTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@pytest.fixture(scope="module")
def problems():
    return (jct.ct_mismatched(n=16, n_angles=24, n_det=24, dense=False),
            tct.ct_mismatched(n=16, n_angles=24, n_det=24))


def _bits(a):
    """The stored bits of a JAX or torch array (bfloat16 as int16)."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16
                else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _operators(problems, dtype):
    """Both packages' CT operators, ``dtype`` None for each function's
    default; the JAX pair runs its kernels in interpret mode.  Asserts
    the panels bit-equal and unscaled."""
    jp, tp = problems
    jkw = {} if dtype is None else {"dtype": JDTYPES[dtype]}
    tkw = {} if dtype is None else {"dtype": dtype}
    jA, jB, jb, jx, jrp, _ = jct.ct_tpu_operators(jp, **jkw)
    jA.interpret = jB.interpret = True
    tA, tB, tb, tx, trp, _ = tct.ct_gpu_operators(tp, device="cpu", **tkw)
    np.testing.assert_array_equal(jrp, trp)
    want = TDTYPES[dtype or "bfloat16"]
    for jo, to in ((jA, tA), (jB, tB)):
        assert to.storage_dtype == want and to.fwd_scale is None
        assert jo.fwd_scale is None
        for (bj, cj), (bt, ct) in zip(jo.fwd.buckets, to.fwd.buckets):
            np.testing.assert_array_equal(_bits(bj), _bits(bt))
            np.testing.assert_array_equal(np.asarray(cj), ct.numpy())
        assert to.fwd_rows.dtype == want
    return (jA, jB, jb, jx, jrp), (tA, tB, tb, tx, trp)


def _close(got_r, want_r, names=("res_hist", "err_hist", "x")):
    for name in names:
        want = np.asarray(getattr(want_r, name))
        got = getattr(got_r, name).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("dtype", [None, "float32"])
def test_ct16_single_matches_jax(problems, dtype):
    """CT n=16 (24x24 rays), BA-GMRES, fused residual, 10 steps, through
    ``ct_tpu_operators`` and ``ct_gpu_operators`` called alike: with no
    dtype (both default to bfloat16) and with float32.  The panels are
    bit-equal and the histories and x within 1e-5 of the max entry
    (float32 sums in other orders), the band of the int8 slice."""
    (jA, jB, jb, jx, _), (tA, tB, tb, tx, _) = _operators(problems, dtype)
    kw = dict(tol=0.0, maxit=10, lam=1e-2, residual="fused")
    jr = jba(jA, jB, jb, jx, **kw)
    tr = tba(tA, tB, tb, tx, **kw)
    assert int(tr.niters) == int(jr.niters) == 10
    _close(tr, jr)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ct16_batched_matches_jax(problems, dtype):
    """The serving slice on bfloat16 and float32 forms: R=3 sinograms
    (seeds 0..2 in original ray order, then permuted) through
    ``ba_gmres_batched`` of both packages, 8 steps, in-loop and deferred,
    within 1e-5 of the max entry."""
    (jA, jB, _, jx, _), (tA, tB, _, tx, trp) = _operators(problems, dtype)
    tp = problems[1]
    b = np.stack([add_noise(tp.b_exact, 0.25, seed=r)[0][trp]
                  for r in range(3)], axis=1)
    for defer in (False, True):
        kw = dict(tol=0.0, maxit=8, lam=1e-2, defer_histories=defer)
        jr = jbb(jA, jB, jnp.asarray(b), jx, **kw)
        tr = tbb(tA, tB, torch.from_numpy(b), tx, **kw)
        assert tr.niters.tolist() == np.asarray(jr.niters).tolist() == [8] * 3
        _close(tr, jr)


def test_operator_moves_between_devices(problems):
    """``BlockELLOperator.to``: itself where it is; elsewhere (the meta
    device here) its forms, scales and ``fro_sq`` moved, the panels
    left on the host."""
    tA = tct.ct_gpu_operators(problems[1], dtype="int8", device="cpu")[0]
    assert tA.to("cpu") is tA
    moved = tA.to("meta")
    assert moved.device.type == "meta" and tA.device.type == "cpu"
    for t in (moved.fwd_rows.vals, moved.adj_rows.cols, moved.fwd_scale,
              moved.fro_sq):
        assert t.device.type == "meta"
    assert moved.fwd is tA.fwd and moved.shape == tA.shape


def test_chip_smoke_reads_the_forms_values(problems):
    """``chip_smoke.py``'s host reference for the float forms reads the
    matrix back from a form's stored values: on the bfloat16 forms of CT
    n=16 it is the reordered float32 matrix rounded to bfloat16, exactly,
    forward and transposed."""
    import importlib.util
    import os

    from hybrid_gmres_tpu_torch.ops.ordering import reorder_pair

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    tp = problems[1]
    A, _, _, _, rp, pp = tct.ct_gpu_operators(tp, device="cpu")
    want = reorder_pair(tp.A_csr.astype(np.float32),
                        tp.B_csr.astype(np.float32), rp, pp)[0]
    want.data = torch.from_numpy(want.data).to(torch.bfloat16).double(
        ).numpy()
    want.eliminate_zeros()
    for got, ref in ((smoke.form_csr(A.fwd_rows), want),
                     (smoke.form_csr(A.adj_rows), want.T.tocsr())):
        assert got.shape == ref.shape and got.nnz == ref.nnz
        assert abs(got - ref).max() == 0


def test_ct_gpu_operators_default_to_the_card(problems):
    """The default device is the card: no silent CPU build (it raises
    where there is no card)."""
    if torch.cuda.is_available():
        assert tct.ct_gpu_operators(problems[1])[0].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tct.ct_gpu_operators(problems[1])


def test_entry_cpu_matches_jax():
    """``entry(device="cpu")`` against the JAX ``entry()``'s CPU branch
    (dense float32 operators, true residual, 20 steps): ``res_hist``
    within rtol 1e-5, the same ``niters``; the card's default raises here
    without a card."""
    import __graft_entry__ as jentry

    from hybrid_gmres_tpu_torch import entry as tentry

    assert tentry.dryrun_multichip.__module__ == \
        "hybrid_gmres_tpu_torch.parallel.dryrun"
    jfn, jargs = jentry.entry()
    assert jargs[0].shape == (8100, 1024)        # the dense CPU branch
    jx, jres, jn = jfn(*jargs)
    fn, args = tentry.entry(device="cpu")
    assert args[2].dtype == torch.float32 and args[2].shape == (8100,)
    x, res, niters = fn(*args)
    assert int(niters) == int(jn) == 20
    assert x.shape == (1024,) and bool(torch.isfinite(x).all())
    np.testing.assert_allclose(res.numpy(), np.asarray(jres), rtol=1e-5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tentry.entry()


@pytest.fixture(scope="module")
def mats():
    """tests/test_sparse.py's matrices."""
    rng = np.random.default_rng(0)
    A = sp.random(300, 260, density=0.05, format="csr", random_state=0,
                  dtype=np.float64)
    x = rng.standard_normal(260)
    u = rng.standard_normal(300)
    return A, x, u


def test_ell_matches_jax(mats):
    """``ell_from_csr`` stores the JAX arrays; ``matvec`` agrees with the
    JAX one and with scipy."""
    A, x, _ = mats
    j = jsparse.ell_from_csr(A, dtype=np.float64)
    t = tsparse.ell_from_csr(A, dtype=np.float64, device="cpu")
    assert t.shape == j.shape == A.shape
    np.testing.assert_array_equal(t.idx.numpy(), np.asarray(j.idx))
    np.testing.assert_array_equal(t.vals.numpy(), np.asarray(j.vals))
    y = t.matvec(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, np.asarray(j.matvec(jnp.asarray(x))),
                               rtol=1e-12)
    np.testing.assert_allclose(y, A @ x, rtol=1e-12)


@pytest.mark.parametrize("block", [(8, 128), (32, 128)])
@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_block_ell_matches_jax(mats, block, dtype):
    """``block_ell_from_csr`` stores the JAX panel bit for bit (bfloat16
    rounded alike), with its block and padded shapes; ``matvec``
    (float32 sums, or float64 for a float64 panel) agrees with the JAX
    one.  ``BucketedBlockELL.matvec`` likewise on the bucketed panel."""
    A, x, _ = mats
    jdt = {"float64": np.float64, "float32": np.float32,
           "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float64": np.float64, "float32": np.float32,
           "bfloat16": torch.bfloat16}[dtype]
    j = jsparse.block_ell_from_csr(A, block=block, dtype=jdt)
    t = tsparse.block_ell_from_csr(A, block=block, dtype=tdt, device="cpu")
    np.testing.assert_array_equal(_bits(t.blocks), _bits(j.blocks))
    np.testing.assert_array_equal(t.bcols.numpy(), np.asarray(j.bcols))
    np.testing.assert_array_equal(t.nblocks.numpy(), np.asarray(j.nblocks))
    assert (t.block_shape, t.padded_shape, t.bcols_cols, t.shape) == (
        tuple(j.block_shape), tuple(j.padded_shape), j.bcols_cols, j.shape)
    rtol = 1e-12 if dtype == "float64" else 1e-5
    for xv in (x, x.astype(np.float32)):
        want = np.asarray(j.matvec(jnp.asarray(xv)))
        got = t.matvec(torch.from_numpy(xv))
        assert got.dtype == torch.from_numpy(xv).dtype
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=rtol * np.abs(want).max())
    jb = jsparse.bucketed_block_ell_from_csr(A, block=block, dtype=jdt,
                                             n_buckets=3)
    tb = tsparse.bucketed_block_ell_from_csr(A, block=block, dtype=tdt,
                                             n_buckets=3, device="cpu")
    want = np.asarray(jb.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(tb.matvec(torch.from_numpy(x)).numpy(), want,
                               rtol=0, atol=rtol * np.abs(want).max())


def test_local_shard_info_one_rank():
    """``local_shard_info`` on a one-rank gloo group: the JAX keys, with
    the rank and world size of ``torch.distributed`` and the CPU's index
    0 as this rank's device."""
    import torch.distributed as dist

    from hybrid_gmres_tpu_torch.parallel import make_mesh
    from hybrid_gmres_tpu_torch.parallel.multihost import local_shard_info

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        info = local_shard_info(make_mesh(device="cpu"))
    finally:
        dist.destroy_process_group()
    assert info == {"mesh_size": 1, "local_device_ids": [0],
                    "process_index": 0, "process_count": 1}


def test_dispatch_floor_seconds():
    """The least wall time of ``x + 1`` and its read-back: finite and
    positive on the CPU; the card by default, which raises without one."""
    from hybrid_gmres_tpu_torch.utils.profiling import dispatch_floor_seconds

    t = dispatch_floor_seconds(repeats=3, device="cpu")
    assert np.isfinite(t) and 0 < t < 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            dispatch_floor_seconds()
