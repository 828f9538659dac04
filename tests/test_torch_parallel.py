"""PyTorch port: the 1-D sharded GMRES path against the JAX package.

The port runs SPMD on 4 gloo ranks, spawned once for this file
(``tests/torch_parallel_cases.py``, which imports no JAX); the JAX side
runs on the conftest's virtual CPU devices, ``make_mesh(4)`` for its
sharded dense solvers, and its single-device solvers where
``tests/test_parallel.py`` holds the sharded ones to them.  The tests
mirror the 1-D cases of ``tests/test_parallel.py`` for the ported modules,
with its tolerances:

  * the dense solvers in float64, rtol 1e-8 on the histories (1e-9 on x);
  * the panel solvers in float32 bands: histories within 5e-5 of the dense
    single-device solve (float32 products summed in other orders), x within
    1e-3 (it carries the ill-conditioned directions);
  * the analytic communication volume exactly.

Not mirrored here: the GSPMD test (line 75; PyTorch has no sharding
propagation short of DTensor) and the two that read XLA's HLO (lines 1164,
1401).  The GKB, RTP, composed-panel and multi-RHS tests are mirrored in
``tests/test_torch_parallel_solvers.py``, the 2-D tests in
``tests/test_torch_parallel_2d.py``.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import hybrid_gmres_tpu.parallel as jpar
from hybrid_gmres_tpu import ab_gmres as jab
from hybrid_gmres_tpu import ba_gmres as jba
from hybrid_gmres_tpu.solvers.gmres import (
    ab_gmres_restarted as jab_restarted,
    ba_gmres_restarted as jba_restarted,
)

import hybrid_gmres_tpu_torch.parallel as tpar
import torch_parallel_cases as cases
from hybrid_gmres_tpu_torch.parallel import panels as tpanels
from hybrid_gmres_tpu_torch.utils.convert import sharded_panels_from_numpy

P = cases.P


@pytest.fixture(scope="module")
def shaw():
    from hybrid_gmres_tpu import generate_test_problem
    from hybrid_gmres_tpu.problems import add_noise, perturb_backprojector

    A, b_exact, x_true = generate_test_problem("shaw", 32)
    b, _ = add_noise(b_exact, 1e-2, seed=0)
    B, _ = perturb_backprojector(A, 1e-4, seed=1)
    return tuple(np.asarray(v, np.float64) for v in (A, B, b, x_true))


@pytest.fixture(scope="module")
def ranks(shaw):
    """Every rank's results of every case (one spawn for the file)."""
    return cases.spawn({"shaw": shaw})


def _case(ranks, name):
    """Rank 0's results of a case; a case that raised fails the test."""
    out = ranks[0][name]
    if isinstance(out, dict) and "traceback" in out:
        pytest.fail(out["traceback"])
    return out


@pytest.fixture(scope="module")
def jmesh():
    return jpar.make_mesh(P)


def _dense_jax():
    A, B, b, xt = cases.dense_prob()
    return tuple(jnp.asarray(v) for v in (A, B, b, xt))


def _j(v, dtype=None):
    return np.asarray(v, dtype=dtype)


def _f32_ref(kind, seed, **kw):
    """The dense single-device JAX solve of a sparse pair, float32."""
    Ad, Bd, b, xt = cases.sparse_pair(64, 32, seed=seed)
    f = jba if kind == "ba" else jab
    return f(*(jnp.asarray(v) for v in (Ad, Bd, b, xt)), **kw)


def _band(got, ref, rtol=5e-5, x_rtol=1e-3, x_atol=1e-5, x=True):
    np.testing.assert_allclose(got["res_hist"], _j(ref.res_hist, np.float32),
                               rtol=rtol)
    np.testing.assert_allclose(got["err_hist"], _j(ref.err_hist, np.float32),
                               rtol=rtol)
    if x:
        np.testing.assert_allclose(got["x"], _j(ref.x, np.float32),
                                   rtol=x_rtol, atol=x_atol)


def test_sharded_matvecs_match_dense(ranks, jmesh):
    A, B, b, xt = _dense_jax()
    out = _case(ranks, "dense_matvecs")
    np.testing.assert_allclose(out["ba"], _j(B @ (A @ xt)), rtol=1e-12)
    np.testing.assert_allclose(out["ab"], _j(A @ (B @ b)), rtol=1e-12)
    A_s, B_s, b_s = jpar.shard_problem(A, B, b, jmesh)
    np.testing.assert_allclose(
        out["ba"], _j(jpar.sharded_ba_matvec(A_s, B_s, jmesh)(xt)),
        rtol=1e-12)
    np.testing.assert_allclose(
        out["ab"], _j(jpar.sharded_ab_matvec(A_s, B_s, jmesh)(b_s)),
        rtol=1e-12)


@pytest.mark.parametrize("lam", [None, 1e-3])
def test_sharded_solver_matches_single_device(ranks, jmesh, lam):
    """``ba_gmres_sharded`` on 4 ranks against the JAX one on a 4-device
    mesh and the single-device ``ba_gmres``, float64."""
    A, B, b, xt = _dense_jax()
    got = _case(ranks, "dense_solve")[str(lam)]
    r_ref = jba(A, B, b, xt, tol=1e-10, maxit=16, lam=lam)
    r_sh = jpar.ba_gmres_sharded(*jpar.shard_problem(A, B, b, jmesh), xt,
                                 tol=1e-10, maxit=16, lam=lam, mesh=jmesh)
    for ref in (r_ref, r_sh):
        np.testing.assert_allclose(got["x"], _j(ref.x), rtol=1e-9,
                                   atol=1e-12)
        np.testing.assert_allclose(got["err_hist"], _j(ref.err_hist),
                                   rtol=1e-8)
        assert int(got["niters"]) == int(ref.niters)


def test_sharded_ill_posed_problem(ranks, jmesh, shaw):
    """shaw n=32 with a perturbed back-projector: the sharded BA-GMRES
    error history against the JAX sharded one, rtol 1e-6."""
    A, B, b, xt = (jnp.asarray(v) for v in shaw)
    got = _case(ranks, "dense_shaw")
    r_sh = jpar.ba_gmres_sharded(*jpar.shard_problem(A, B, b, jmesh), xt,
                                 tol=1e-6, maxit=16, lam=1e-3, mesh=jmesh)
    np.testing.assert_allclose(got["err_hist"], _j(r_sh.err_hist), rtol=1e-6)


@pytest.mark.parametrize("lam", [None, 1e-3])
def test_sharded_basis_solver_matches_single_device(ranks, jmesh, lam):
    """The row-sharded basis (one fused all_reduce per CGS2 pass) against
    the single-device ``ba_gmres`` and the JAX sharded-basis solver."""
    A, B, b, xt = _dense_jax()
    got = _case(ranks, "basis")[f"ba {lam}"]
    r_ref = jba(A, B, b, xt, tol=1e-10, maxit=16, lam=lam)
    refs = [r_ref]
    if lam is None:
        refs.append(jpar.ba_gmres_sharded_basis(
            *jpar.shard_problem(A, B, b, jmesh), xt, tol=1e-10, maxit=16,
            lam=lam, mesh=jmesh))
    for ref in refs:
        np.testing.assert_allclose(got["x"], _j(ref.x), rtol=1e-9,
                                   atol=1e-12)
        np.testing.assert_allclose(got["err_hist"], _j(ref.err_hist),
                                   rtol=1e-8)
        assert int(got["niters"]) == int(ref.niters)
    assert got["Q"].shape == (32 // P, 17)      # this rank's basis slab


def test_sharded_basis_requires_divisible_dims(ranks):
    out = ranks[0]["basis_divisible"]
    assert out["error"] == "ValueError" and "must divide" in out["message"]


@pytest.mark.parametrize("lam", [None, 1e-3])
def test_ab_sharded_basis_matches_single_device(ranks, lam):
    """The m-space basis sharded over the rays against ``ab_gmres``."""
    A, B, b, xt = _dense_jax()
    got = _case(ranks, "basis")[f"ab {lam}"]
    ref = jab(A, B, b, xt, tol=1e-10, maxit=16, lam=lam)
    np.testing.assert_allclose(got["x"], _j(ref.x), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got["err_hist"], _j(ref.err_hist), rtol=1e-8)
    assert int(got["niters"]) == int(ref.niters)
    assert got["Q"].shape == (40 // P, 17)


def test_initialize_multihost_noop_single_host(monkeypatch):
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert tpar.initialize_multihost() is False
    assert jpar.initialize_multihost() is False


def test_mesh_builders(ranks):
    """Without a process group the mesh builders raise; on the gloo ranks
    ``make_mesh()`` (NCCL on the card by default) raises without a card, a
    mesh larger than the job is refused, the 2-D mesh is row-major and a
    replica fleet reduces inside each replica only."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        tpar.make_mesh(device="cpu")
    out = _case(ranks, "meshes")
    assert out["cuda"] == "RuntimeError" and out["too_many"] == "ValueError"
    for rank, res in enumerate(ranks):
        m = res["meshes"]
        np.testing.assert_array_equal(m["coords"], divmod(rank, 2))
        np.testing.assert_array_equal(m["replica"],
                                      [1, rank // 2, rank % 2, 2])
        lo = 2 * (rank // 2)
        assert float(m["replica_sum"][0]) == lo + lo + 1


@pytest.mark.parametrize("kind", ["ba", "ab"])
def test_sharded_basis_fused_residual_matches_true(ranks, kind):
    """The fused residual (stored image bases, fewer collectives) equals
    the true residual to rtol 1e-9, and both match the single-device solve
    of the same kind to 1e-8."""
    A, B, b, xt = _dense_jax()
    out = _case(ranks, "basis")
    rt, rf = out[f"{kind} true"], out[f"{kind} fused"]
    for name in ("res_hist", "err_hist"):
        np.testing.assert_allclose(rf[name], rt[name], rtol=1e-9)
    np.testing.assert_allclose(rf["x"], rt["x"], rtol=1e-9, atol=1e-12)
    ref = (jba if kind == "ba" else jab)(A, B, b, xt, tol=0.0, maxit=12,
                                         lam=1e-3)
    np.testing.assert_allclose(rt["res_hist"], _j(ref.res_hist), rtol=1e-8)
    np.testing.assert_allclose(rt["err_hist"], _j(ref.err_hist), rtol=1e-8)


@pytest.mark.parametrize("kind", ["ba", "ab"])
def test_sharded_pallas_solver_matches_dense(ranks, kind):
    """Per-shard row-packed forms (plain K1/K3) and the reduce-scatter
    schedule against the dense single-device JAX solver; the collectives
    of one solve are the schedule's: per step 4 all_reduces (2 CGS2, the
    norm, residual + error) and one gather for A's rows, one
    reduce_scatter for B (BA: one more for r0 = B b; 3 all_reduces for the
    norms of b, x_true and r0; one all_gather of the final x)."""
    got = _case(ranks, "pallas_dense")[kind]
    _band(got, _f32_ref(kind, 1, tol=0.0, maxit=cases.MAXIT, lam=1e-3))
    if kind == "ba":    # and the JAX sharded solver itself, p=4
        Ad, Bd, b, xt = cases.sparse_pair(64, 32)
        jr = jpar.ba_gmres_sharded_pallas(
            jpar.shard_bucketed_panels(sp.csr_matrix(Ad), P),
            jpar.shard_bucketed_panels(sp.csr_matrix(Bd.T), P),
            jnp.asarray(b), jnp.asarray(xt), tol=0.0, maxit=cases.MAXIT,
            lam=1e-3, mesh=jpar.make_mesh(P), interpret=True)
        _band(got, jr)
    k = cases.MAXIT
    np.testing.assert_array_equal(
        got["calls"], [4 * k + 3, k + 1, k + (kind == "ba"), 0])


def test_sharded_panels_windowed_exchange(ranks):
    """A block-banded operator on a block-aligned mesh gets the static
    window (L < p shifts, fewer gather bytes than an all_gather), the same
    window as the JAX package's panels, and the solver still reproduces the
    dense one."""
    Ad = cases.banded(P, 3, offsets=cases.UPPER_BAND)
    n = Ad.shape[0]
    tp = tpar.shard_bucketed_panels(Ad, P)
    jp = jpar.shard_bucketed_panels(Ad, P)
    assert tp.windowed and jp.windowed
    dmin, L = tp.shifts
    assert L < P and (tp.shifts, tp.win_slabs, tp.slab_blocks) == \
        (tuple(jp.shifts), jp.win_slabs, jp.slab_blocks)
    np.testing.assert_array_equal(tp.win_start.numpy(), _j(jp.win_start))
    comms = tpar.comms_bytes_per_iteration(tp)
    assert comms == jpar.comms_bytes_per_iteration(jp)
    assert comms["gather_bytes"] < (P - 1) * (n // P) * 4

    got = _case(ranks, "windowed")
    rng = np.random.default_rng(3)
    Bd = (Ad.T + cases._rand_sparse(n, 5)).tocsr()
    xt = rng.standard_normal(n).astype(np.float32)
    b = (Ad @ xt + 0.01 * rng.standard_normal(n)).astype(np.float32)
    ref = jba(jnp.asarray(Ad.toarray()), jnp.asarray(Bd.toarray()),
              jnp.asarray(b), jnp.asarray(xt), tol=0.0, maxit=6, lam=1e-3)
    np.testing.assert_allclose(got["res_hist"], _j(ref.res_hist, np.float32),
                               rtol=5e-5)
    np.testing.assert_allclose(got["x"], _j(ref.x, np.float32), rtol=1e-3,
                               atol=1e-5)
    nonzero_shifts = sum((dmin + i) % P != 0 for i in range(L))
    assert int(got["shifts_issued"]) == 6 * nonzero_shifts > 0


def test_sharded_panels_matvec_primitives(ranks):
    """gather_window / local_matvec / local_rmatvec_window /
    scatter_window_to_full + collectives against the CSR products, on a
    block-aligned and a small operator."""
    out = _case(ranks, "primitives")
    for n, density in ((128 * P, 0.02), (32 * P, 0.2)):
        A = sp.random(n, n, density=density, random_state=7, format="csr",
                      dtype=np.float64).astype(np.float32)
        x = np.random.default_rng(11).standard_normal(n).astype(np.float32)
        u = np.random.default_rng(12).standard_normal(n).astype(np.float32)
        np.testing.assert_allclose(out[str(n)]["y"], A @ x, rtol=2e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(out[str(n)]["z"], A.T @ u, rtol=2e-5,
                                   atol=1e-5)


def _quantized_checks(got, Ad, x, u, qmax, exact_band):
    from hybrid_gmres_tpu.ops.spmv_pallas import _row_quantize_csr

    Aq, sA = _row_quantize_csr(sp.csr_matrix(Ad), qmax=qmax)
    y, z = got["y"], got["z"]
    ref_q = sA * (Aq @ x)
    ref_t = Aq.T @ (sA * u)
    assert np.linalg.norm(y - ref_q) / np.linalg.norm(ref_q) < 1e-5
    assert np.linalg.norm(z - ref_t) / np.linalg.norm(ref_t) < 1e-5
    assert np.linalg.norm(y - Ad @ x) / np.linalg.norm(Ad @ x) < exact_band
    lhs, rhs = float(np.dot(y, u)), float(np.dot(x, z))
    assert abs(lhs - rhs) / max(abs(lhs), 1e-6) < 1e-5, (lhs, rhs)


def test_sharded_panels_int8_quantized(ranks):
    """int8 sharded panels: per-row scales, products within 1e-5 of the
    exact quantized diag(s) Q, ~1e-2 of the float operator, an exact
    adjoint pair, and the exact per-shard ||A||_F^2 of the JAX panels.
    (The JAX test's sharded LSQR solve waits for the sharded GKB port.)"""
    Ad = cases.sparse_pair(64, 32, seed=6)[0]
    tp = tpar.shard_bucketed_panels(sp.csr_matrix(Ad), P, dtype=np.int8)
    jp = jpar.shard_bucketed_panels(sp.csr_matrix(Ad), P, dtype=np.int8)
    assert tp.row_scale is not None and not tp.packed4
    assert tp.shards[0].fwd_rows.dtype == torch.int8
    np.testing.assert_array_equal(tp.row_scale.numpy(), _j(jp.row_scale))
    np.testing.assert_allclose(tp.fro_sq.numpy(), _j(jp.fro_sq), rtol=1e-6)
    np.testing.assert_allclose(float(tp.fro_sq.sum()), float((Ad * Ad).sum()),
                               rtol=1e-5)
    x = np.random.default_rng(7).standard_normal(32).astype(np.float32)
    u = np.random.default_rng(8).standard_normal(64).astype(np.float32)
    _quantized_checks(_case(ranks, "quantized")["int8"], Ad, x, u, 127, 2e-2)


def test_sharded_panels_int4_packed(ranks):
    """int4 sharded panels: nibble-pair forms, per-row scales (qmax=7), the
    products within 1e-5 of diag(s) Q through the exchange and both
    kernels, ~7% from the float operator, an exact adjoint pair."""
    Ad = cases.sparse_pair(64, 32, seed=9)[0]
    tp = tpar.shard_bucketed_panels(sp.csr_matrix(Ad), P, dtype="int4")
    assert tp.packed4 and tp.row_scale is not None
    assert all(s.fwd_rows.packed4 and s.adj_rows.packed4 for s in tp.shards)
    x = np.random.default_rng(7).standard_normal(32).astype(np.float32)
    u = np.random.default_rng(8).standard_normal(64).astype(np.float32)
    _quantized_checks(_case(ranks, "quantized")["int4"], Ad, x, u, 7, 0.15)


def test_sharded_panels_int4_packed_windowed(ranks):
    """int4 panels with the window active: a banded operator keeps L < p
    (the per-block scan of the unpacked panel ignores packing padding) and
    both kernels match diag(s) Q through the shifts."""
    Ad = cases.banded(P, 13)
    tp = tpar.shard_bucketed_panels(Ad, P, dtype="int4")
    jp = jpar.shard_bucketed_panels(Ad, P, dtype="int4")
    assert tp.packed4 and tp.windowed and tp.shifts[1] < P
    assert tuple(jp.shifts) == tp.shifts
    rng = np.random.default_rng(13)
    x = rng.standard_normal(Ad.shape[1]).astype(np.float32)
    u = rng.standard_normal(Ad.shape[0]).astype(np.float32)
    _quantized_checks(_case(ranks, "quantized")["int4 windowed"], Ad, x, u, 7,
                      0.15)


def test_sharded_pallas_adaptive_gcv_matches_single_device(ranks):
    """lam='gcv': every rank picks the same per-iteration lambda from the
    replicated projected problem, as the single-device solver does."""
    got = _case(ranks, "gcv")
    ref = _f32_ref("ba", 11, tol=0.0, maxit=6, lam="gcv",
                   gcv_grid=np.logspace(-6, -1, 12))
    np.testing.assert_allclose(got["err_hist"], _j(ref.err_hist, np.float32),
                               rtol=1e-4)
    np.testing.assert_allclose(got["x"], _j(ref.x, np.float32), rtol=1e-3,
                               atol=1e-5)


@pytest.mark.parametrize("kind", ["ba", "ab"])
def test_sharded_restarted_matches_single_device(ranks, kind):
    """The restarted sharded solvers chain the replicated warm start across
    cycles and reproduce the single-device restarted wrappers."""
    got = _case(ranks, "restarted")[kind]
    Ad, Bd, b, xt = cases.sparse_pair(64, 32, seed=19)
    f = jba_restarted if kind == "ba" else jab_restarted
    ref = f(*(jnp.asarray(v) for v in (Ad, Bd, b, xt)), tol=1e-10,
            restart=4, max_restarts=3, lam=1e-3)
    assert int(got["niters"]) == int(ref.niters)
    np.testing.assert_allclose(got["res_hist"], _j(ref.res_hist, np.float32),
                               rtol=5e-4, atol=1e-6)
    np.testing.assert_allclose(got["x"], _j(ref.x, np.float32), rtol=1e-2,
                               atol=1e-4)


@pytest.mark.parametrize("kind", ["ba", "ab"])
def test_sharded_pallas_resume_equals_uninterrupted(ranks, kind):
    """Resume from a 6-step checkpoint (this rank's basis and image slabs)
    to 12 steps equals the uninterrupted 12-step run: rtol 2e-4 on the
    histories (the padded bases reduce in another order), x 1e-3."""
    out = _case(ranks, "resume")[kind]
    assert out["has"][0] and out["has"][1] == (kind == "ab")
    full, res = out["full"], out["resumed"]
    for name in ("res_hist", "err_hist"):
        np.testing.assert_allclose(res[name], full[name], rtol=2e-4)
    np.testing.assert_allclose(res["x"], full["x"], rtol=1e-3, atol=1e-6)
    assert int(res["niters"]) == int(full["niters"])


def test_ba_sharded_pallas_resume_after_tol_stop(ranks):
    """Resuming a run that converged early continues from its niters and
    equals the uninterrupted larger-budget run, which stops where the
    single-device solver does."""
    out = _case(ranks, "resume")["tol"]
    assert int(out["half"]["niters"]) < 10
    assert np.isfinite(out["resumed"]["x"]).all()
    assert int(out["resumed"]["niters"]) == int(out["full"]["niters"])
    np.testing.assert_allclose(out["resumed"]["x"], out["full"]["x"],
                               rtol=1e-4, atol=1e-6)
    Ad, Bd, b, xt = cases.well_conditioned()
    ref = jba(*(jnp.asarray(v) for v in (Ad, Bd, b, xt)), tol=1e-3, maxit=14)
    assert int(out["full"]["niters"]) == int(ref.niters)


def test_sharded_restarted_zero_rhs(ranks):
    """b = 0 gives x = 0 with niters = 0, as on one device."""
    got = _case(ranks, "restarted")["zero"]
    Ad, Bd, _, xt = cases.sparse_pair(64, 32, seed=34)
    z = jnp.zeros(64, jnp.float32)
    ref = jba_restarted(jnp.asarray(Ad), jnp.asarray(Bd), z, jnp.asarray(xt),
                        tol=1e-6, restart=4, max_restarts=3)
    assert int(got["niters"]) == int(ref.niters) == 0
    np.testing.assert_array_equal(got["x"], 0.0)


@pytest.mark.parametrize("kind", ["ba", "ab"])
def test_forward_b_layout_matches_dense(ranks, kind):
    """B through K1 on its own pixel-row panels (a gather of the m-sharded
    intermediate, no reduction), BT_panels=None: the dense solver's
    histories to 5e-5."""
    got = _case(ranks, "forward")[kind]
    _band(got, _f32_ref(kind, 1, tol=0.0, maxit=cases.MAXIT, lam=1e-3),
          x=False)


def test_forward_b_layout_restarted_and_resume(ranks):
    """The forward layout through the resume path and the restarted
    wrapper."""
    out = _case(ranks, "forward")
    np.testing.assert_allclose(out["resumed"]["res_hist"],
                               out["full"]["res_hist"], rtol=2e-5)
    assert int(out["restarted"]["niters"]) > 0
    assert np.isfinite(out["restarted"]["res_hist"]).all()


def test_forward_b_layout_validation_and_comms(ranks):
    """Missing both layouts raises; wrong-shape forward panels raise; the
    communication model swaps the reduce_scatter term for B's gather, as
    the JAX package's does, to the byte."""
    out = _case(ranks, "forward_validation")
    assert "BT_panels" in out["none"] and "or B_panels" in out["none"]
    assert out["shape"].startswith("B panels")
    Ad, Bd, _, _ = cases.sparse_pair(64, 32)
    tA, tB = (tpar.shard_bucketed_panels(sp.csr_matrix(a), P)
              for a in (Ad, Bd))
    jA, jB = (jpar.shard_bucketed_panels(sp.csr_matrix(a), P)
              for a in (Ad, Bd))
    c_t = tpar.comms_bytes_per_iteration(tA, kdim=10)
    c_f = tpar.comms_bytes_per_iteration(tA, kdim=10, B_panels=tB)
    assert c_t == jpar.comms_bytes_per_iteration(jA, kdim=10)
    assert c_f == jpar.comms_bytes_per_iteration(jA, kdim=10, B_panels=jB)
    assert c_f == jpar.comms_bytes_per_iteration(
        jA, kdim=10, B_panels=jB, comm_itemsize=4)
    assert tpar.comms_bytes_per_iteration(tA, comm_itemsize=2) == \
        jpar.comms_bytes_per_iteration(jA, comm_itemsize=2)
    assert c_f["b_gather_bytes"] == (P - 1) * (64 // P) * 4
    assert c_t["reduce_scatter_bytes"] == (P - 1) * (32 // P) * 4


@pytest.mark.parametrize("layout", ["transposed", "forward"])
def test_comm_dtype_bf16_band(ranks, layout):
    """comm_dtype=bfloat16 rounds the exchanged slabs: the residual history
    moves, but stays within 3e-2 of the float32-exchange run."""
    out = _case(ranks, "comm_dtype")[layout]
    r32, rbf = out["f32"]["res_hist"], out["bf16"]["res_hist"]
    assert np.isfinite(rbf).all()
    band = np.max(np.abs(rbf - r32) / np.maximum(np.abs(r32), 1e-6))
    assert 0 < band < 3e-2, band


def test_all_reduce_keeps_a_views_owner(ranks):
    """``Mesh.all_reduce`` sums a fresh tensor in place (no copy) and a
    view of stored state on a copy: the tensor the view reads survives the
    sum.  ``local_shard_info`` gives each rank its place in the mesh."""
    weights = sum(r + 1 for r in range(P))
    base = np.arange(6, dtype=np.float64).reshape(2, 3)
    for rank, res in enumerate(ranks):
        out = res["all_reduce_view"]
        if isinstance(out, dict) and "traceback" in out:
            pytest.fail(out["traceback"])
        np.testing.assert_array_equal(out["owner"], out["kept"])
        np.testing.assert_array_equal(out["owner"], base * (rank + 1))
        np.testing.assert_array_equal(out["row"], base[1] * weights)
        assert out["fresh_in_place"]
        np.testing.assert_array_equal(out["fresh"], base.sum(0) * weights)
        assert out["info"] == {"mesh_size": P, "local_device_ids": [0],
                               "process_index": rank, "process_count": P}


def test_results_replicated_on_every_rank(ranks):
    """Every rank returns the same replicated x and histories (the
    collectives give every rank the same bits), and its own basis slab."""
    for name in ("dense_solve", "basis", "pallas_dense", "windowed", "gcv",
                 "restarted", "forward"):
        first = _case(ranks, name)
        leaves = first.items() if "x" not in first else [("", first)]
        for key, res in leaves:
            for other in ranks[1:]:
                o = other[name] if key == "" else other[name][key]
                for field in ("x", "res_hist", "err_hist"):
                    np.testing.assert_array_equal(o[field], res[field],
                                                  err_msg=f"{name} {key}")


@pytest.mark.parametrize("dtype,window", [
    ("float32", True), ("int8", False), ("int4", False), ("int4", True)])
def test_sharded_panels_from_jax_leaves(dtype, window):
    """``utils.convert.sharded_panels_from_numpy`` on the JAX panels'
    leaves gives the forms, scales and windows of the port's own build of
    the same matrix, bit for bit (the JAX bucket padding never reaches a
    form)."""
    Ad = cases.banded(P, 21) if window else sp.csr_matrix(
        cases.sparse_pair(64, 32, seed=4)[0])
    dt = {"float32": np.float32, "int8": np.int8, "int4": "int4"}[dtype]
    jp = jpar.shard_bucketed_panels(Ad, P, dtype=dt)
    tp = tpar.shard_bucketed_panels(Ad, P, dtype=dt)
    conv = sharded_panels_from_numpy(
        [(np.asarray(b), np.asarray(c)) for b, c in jp.buckets],
        np.asarray(jp.inv_perm), np.asarray(jp.win_start), jp.shape, jp.ncb,
        jp.win_slabs, jp.slab_blocks, jp.shifts, jp.row_group, jp.p,
        packed4=jp.packed4,
        row_scale=None if jp.row_scale is None else np.asarray(jp.row_scale),
        fro_sq=np.asarray(jp.fro_sq), device="cpu")
    assert tp.windowed == window == conv.windowed
    assert (conv.shifts, conv.win_slabs, conv.packed4) == \
        (tp.shifts, tp.win_slabs, tp.packed4)
    for a, b in zip(conv.shards, tp.shards):
        assert a.win_start == b.win_start
        for fa, fb in ((a.fwd_rows, b.fwd_rows), (a.adj_rows, b.adj_rows)):
            assert (fa.shape, fa.lanes, fa.live, fa.packed4) == \
                (fb.shape, fb.lanes, fb.live, fb.packed4)
            for f in ("vals", "cols", "vec_off", "row_map"):
                assert torch.equal(getattr(fa, f), getattr(fb, f)), f
        if b.row_scale is not None:
            assert torch.equal(a.row_scale, b.row_scale)


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_shard_view_drives_windowed_shards_on_one_process(dtype):
    """The windowed forms of a p=4 build, one shard at a time through
    ``shard_view`` and ``host_window_x`` (no communication, as on one card):
    the concatenated K1 outputs are A x and the scattered K3 partials sum
    to A^T u of the same quantized operator (the JAX package's single-chip
    product on the whole matrix, interpret mode)."""
    from hybrid_gmres_tpu.ops.spmv_pallas import PallasBSROperator

    Ad = cases.banded(P, 31)
    tp = tpar.shard_bucketed_panels(Ad, P, dtype=dtype)
    assert tp.windowed
    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.standard_normal(Ad.shape[1]).astype(np.float32))
    u = torch.from_numpy(rng.standard_normal(Ad.shape[0]).astype(np.float32))
    mloc = Ad.shape[0] // P
    ys, z = [], torch.zeros(Ad.shape[1])
    for i in range(P):
        view = tpanels.shard_view(tp, i, "cpu")
        ys.append(tpanels.local_matvec(view, tpanels.host_window_x(tp, i, x)))
        z += tpanels.scatter_window_to_full(view, tpanels.local_rmatvec_window(
            view, u[i * mloc:(i + 1) * mloc]))
    jop = PallasBSROperator.from_csr(Ad, dtype=dtype, with_adjoint=False,
                                     interpret=True)
    for got, want in ((torch.cat(ys), jop.matvec(jnp.asarray(x.numpy()))),
                      (z, jop.rmatvec(jnp.asarray(u.numpy())))):
        want = np.asarray(want)
        err = np.max(np.abs(got.numpy() - want))
        assert err <= 1e-5 * np.max(np.abs(want)), err


def test_shard_view_on_its_device_is_used_as_is():
    """A rank's view already on the mesh's device is what the solvers run
    on, with no copy: ``shard_view`` of it and the solvers' placement
    (``sharded_rows._on_device``, which the restarted wrappers call once
    for all cycles) hand back the same tensors; a host-built panel's
    shard is placed from the full build."""
    from types import SimpleNamespace

    from hybrid_gmres_tpu_torch.parallel import sharded_rows

    tp = tpar.shard_bucketed_panels(cases.banded(P, 31), P, dtype="int8")
    mesh = SimpleNamespace(index=2, device=torch.device("cpu"))
    view = tpanels.shard_view(tp, mesh.index, mesh.device)
    again, none = sharded_rows._on_device(mesh, view, None)
    assert none is None and again.first == 2 and len(again.shards) == 1
    for got in (again, tpanels.shard_view(view, 2, "cpu")):
        a, b = got.shards[0], view.shards[0]
        for f in ("vals", "cols", "vec_off", "row_map"):
            assert getattr(a.fwd_rows, f) is getattr(b.fwd_rows, f)
            assert getattr(a.adj_rows, f) is getattr(b.adj_rows, f)
        assert a.row_scale is b.row_scale
    full = sharded_rows._on_device(mesh, tp)[0]
    assert full.shards[0].fwd_rows.vals is tp.shards[2].fwd_rows.vals
