"""PyTorch port: the rest of the 1-D sharded tier (the sharded RTP, GKB and
multi-RHS GMRES solvers and their panel shapes) against the JAX package.

The port runs SPMD on 4 gloo ranks, spawned once for this file (the
``SOLVER_CASES`` of ``tests/torch_parallel_cases.py``, which imports no
JAX).  The tests mirror the 1-D cases of ``tests/test_parallel.py`` for
these modules (its lines 318, 335, 361, 382, 400, 417, 435, 457, 517,
584, 769, 800, 1272, 1439, 1488, 1513, 1552, 1663, 1696, 1725, 1760,
1914, 1938, 1982, 2001, 2037, 2068, 2094 and 2348), with their
tolerances:

  * the dense-slab solvers in float64, rtol 1e-8 against the JAX
    single-device solvers;
  * the panel solvers in the JAX tests' float32 bands against the JAX
    single-device solvers (the JAX tests' own oracles);
  * the four multi-RHS primitives, and ``PanelsWithAdjoint`` /
    ``ComposedPanels`` carried over from the JAX package's panels by the
    converters, against the JAX functions themselves on ``make_mesh(4)``
    (Pallas in interpret mode).

The replica fleet runs 2 replicas of 2 ranks (the JAX test: 2 of 4).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

import hybrid_gmres_tpu.parallel as jpar
from hybrid_gmres_tpu import ab_gmres_rtp as jab_rtp
from hybrid_gmres_tpu import ba_gmres_rtp as jba_rtp
from hybrid_gmres_tpu.ops.spmv_pallas import _row_quantize_csr
from hybrid_gmres_tpu.solvers.batched import (
    ab_gmres_batched as jab_batched,
    ba_gmres_batched as jba_batched,
)
from hybrid_gmres_tpu.solvers.lsmr import hybrid_lsmr as jhybrid_lsmr
from hybrid_gmres_tpu.solvers.lsmr import lsmr as jlsmr
from hybrid_gmres_tpu.solvers.lsqr import hybrid_lsqr as jhybrid_lsqr
from hybrid_gmres_tpu.solvers.lsqr import lsqr as jlsqr

import hybrid_gmres_tpu_torch.parallel as tpar
import torch_parallel_cases as cases

P = cases.P


def _leaves(jp):
    """A JAX ShardedPanels' leaves as the keywords of
    ``sharded_panels_from_numpy``."""
    return dict(
        buckets=[(np.asarray(b), np.asarray(c)) for b, c in jp.buckets],
        inv_perm=np.asarray(jp.inv_perm), win_start=np.asarray(jp.win_start),
        shape=jp.shape, ncb=jp.ncb, win_slabs=jp.win_slabs,
        slab_blocks=jp.slab_blocks, shifts=jp.shifts, row_group=jp.row_group,
        p=jp.p, packed4=jp.packed4,
        row_scale=None if jp.row_scale is None else np.asarray(jp.row_scale),
        fro_sq=np.asarray(jp.fro_sq))


def _jpanels(a, **kw):
    return jpar.shard_bucketed_panels(sp.csr_matrix(a), P, **kw)


@pytest.fixture(scope="module")
def deriv2():
    """tests/test_parallel.py's deriv2 problem (n=32, 1% noise) and the
    warm starts its hybrid LSQR and LSMR tests draw."""
    from hybrid_gmres_tpu import generate_test_problem
    from hybrid_gmres_tpu.problems import add_noise

    A, b_exact, x_true = generate_test_problem("deriv2", 32)
    b, _ = add_noise(b_exact, 1e-2, seed=0)
    A, b, xt = (np.asarray(v, np.float64) for v in (A, b, x_true))
    x0_lsqr = xt + 0.2 * np.random.default_rng(5).standard_normal(32)
    x0_lsmr = xt + 0.3 * np.random.default_rng(3).standard_normal(32)
    return A, b, xt, x0_lsqr, x0_lsmr


@pytest.fixture(scope="module")
def converted():
    """The JAX package's PanelsWithAdjoint and ComposedPanels of the seed-13
    pair, the leaves the ranks convert, and the JAX sharded LSQR on them
    (make_mesh(4), interpret mode)."""
    Ad, Bd, b, xt = cases.sparse_pair(64, 32, seed=13)
    jpair = jpar.PanelsWithAdjoint(_jpanels(Ad), _jpanels(Ad.T.copy()))
    jM = jpar.ComposedPanels(_jpanels(Ad), _jpanels(Bd.T), "ba")
    mesh = jpar.make_mesh(P)
    kw = dict(tol=0.0, maxit=4, mesh=mesh, interpret=True)
    refs = {"pair": jpar.lsqr_sharded(jpair, jnp.asarray(b),
                                      jnp.asarray(xt), **kw),
            "composed": jpar.lsqr_sharded(
                jM, jnp.asarray((Bd @ b).astype(np.float32)),
                jnp.asarray(xt), **kw)}
    leaves = {"pair": (_leaves(jpair.A), _leaves(jpair.AT)),
              "composed": (_leaves(jM.A), _leaves(jM.BT), "ba")}
    return leaves, refs


@pytest.fixture(scope="module")
def ranks(deriv2, converted):
    """Every rank's results of every solver case (one spawn for the
    file)."""
    return cases.spawn({"deriv2": deriv2, "converted": converted[0]},
                       group="solvers")


def _case(ranks, name):
    out = ranks[0][name]
    if isinstance(out, dict) and "traceback" in out:
        pytest.fail(out["traceback"])
    return out


def _j(v, dtype=None):
    return np.asarray(v, dtype=dtype)


def _dense():
    A, _, b, xt = cases.dense_prob()
    return tuple(jnp.asarray(v) for v in (A, b, xt))


def _close(got, ref, names, dtype=None, **tol):
    for name in names:
        np.testing.assert_allclose(got[name], _j(getattr(ref, name), dtype),
                                   err_msg=name, **tol)


# ---------------------------------------------------------------------------
# GKB on dense slabs (float64): test_parallel.py 318, 335, 382, 400, 417, 457
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["lsqr", "hybrid_lsqr", "lsmr",
                                  "hybrid_lsmr last", "hybrid_lsmr first"])
def test_gkb_sharded_matches_single_device(ranks, name):
    """Each sharded GKB solver on 4 ranks' dense slabs against the JAX
    single-device solver, float64: x and every history to rtol 1e-8 (LSMR's
    ||A^T r|| history to the JAX test's 1e-6), niters equal."""
    A, b, xt = _dense()
    got = _case(ranks, "gkb_dense")[name]
    kw = dict(tol=1e-12, maxit=16)
    ref = {"lsqr": lambda: jlsqr(A, b, xt, **kw),
           "hybrid_lsqr": lambda: jhybrid_lsqr(A, b, xt, lam=1e-3, **kw),
           "lsmr": lambda: jlsmr(A, b, xt, **kw)}.get(name) or (
        lambda: jhybrid_lsmr(A, b, xt, lam=1e-3,
                             rank1_mode=name.split()[1], **kw))
    ref = ref()
    np.testing.assert_allclose(got["x"], _j(ref.x), rtol=1e-8, atol=1e-12)
    _close(got, ref, ("err_hist", "res_hist"), rtol=1e-8)
    if name == "lsmr":
        _close(got, ref, ("ar_hist",), rtol=1e-6)
    assert int(got["niters"]) == int(ref.niters)


def test_lsqr_sharded_resume_equals_uninterrupted(ranks):
    """Resume 8 -> 16 from this rank's checkpoint equals the uninterrupted
    16-step run to 1e-12, the true-residual patch made again; the state
    keeps the unpatched estimate history."""
    out = _case(ranks, "gkb_dense")["resume"]
    full, res = out["full"], out["resumed"]
    for name in ("res_hist", "err_hist", "x"):
        np.testing.assert_allclose(res[name], full[name], rtol=1e-12)
    assert int(res["niters"]) == int(full["niters"])
    assert float(out["half_state_res"][-1]) != float(
        out["half"]["res_hist"][-1])


def test_equivalence_sharded_gkb_vs_sharded_gmres(ranks):
    """With B = A^T the sharded BA-GMRES equals the sharded LSMR and the
    sharded AB-GMRES the sharded LSQR over the first 6 steps (rtol 1e-6,
    run_equivalence_plots.m:12-22)."""
    out = _case(ranks, "gkb_dense")["equivalence"]
    for gmres, gkb in (("ba", "lsmr"), ("ab", "lsqr")):
        np.testing.assert_allclose(out[gmres]["err_hist"],
                                   out[gkb]["err_hist"], rtol=1e-6)


# ---------------------------------------------------------------------------
# GKB on deriv2 (float64): 1914, 1938, 1982, 2001, 2068
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["lsqr", "lsmr", "hybrid_lsmr"])
def test_sharded_gkb_reorth_matches_single_chip(ranks, deriv2, name):
    """reorth=True (the sharded CGS2 purification, one fused all_reduce a
    pass) against the JAX single-device reorth run, rtol 1e-8."""
    A, b, xt = (jnp.asarray(v) for v in deriv2[:3])
    f = {"lsqr": jlsqr, "lsmr": jlsmr, "hybrid_lsmr": jhybrid_lsmr}[name]
    kw = {"lam": 1e-3} if name == "hybrid_lsmr" else {}
    ref = f(A, b, xt, tol=0.0, maxit=12, reorth=True, **kw)
    got = _case(ranks, "gkb_deriv2")["reorth"][name]
    _close(got, ref, ("res_hist", "err_hist"), rtol=1e-8, atol=1e-12)


def test_hybrid_lsqr_sharded_x0_resume_reorth(ranks, deriv2):
    """The exact Tikhonov warm start against the JAX single-device one
    (rtol 1e-8); resume 4 -> 8 equals the uninterrupted run bit for bit,
    with and without reorth; a resume with the other reorth raises."""
    A, b, xt, x0, _ = (jnp.asarray(v) for v in deriv2)
    out = _case(ranks, "gkb_deriv2")
    ref = jhybrid_lsqr(A, b, xt, tol=0.0, maxit=8, lam=1e-3, x0=x0)
    got = out["hybrid_lsqr_x0"]
    _close(got, ref, ("res_hist", "err_hist"), rtol=1e-8)
    np.testing.assert_allclose(got["x"], _j(ref.x), rtol=1e-8, atol=1e-12)
    for reorth in (False, True):
        r = out[f"hybrid_lsqr_resume {reorth}"]
        for name in ("res_hist", "x"):
            np.testing.assert_array_equal(r["resumed"][name],
                                          r["full"][name])
    assert "reorth" in out["reorth_mismatch"]


def test_lsmr_sharded_resume_equals_uninterrupted(ranks):
    """Resume 4 -> 8 continues the recurrence bit for bit, ||A^T r||
    history included."""
    r = _case(ranks, "gkb_deriv2")["lsmr_resume"]
    for name in ("res_hist", "ar_hist", "x"):
        np.testing.assert_array_equal(r["resumed"][name], r["full"][name])


@pytest.mark.parametrize("pair", [("ba", "lsmr", 1e-7), ("ab", "lsqr", 1e-7),
                                  ("hba", "hlsmr", 1e-6)])
def test_sharded_equivalence_full_history_with_reorth(ranks, pair):
    """The full-depth equivalence oracles (run_equivalence_plots.m:26-58)
    at scale: with reorthogonalized sharded GKB, the 32-step histories of
    sharded LSMR == BA-GMRES, LSQR == AB-GMRES, hybrid LSMR == hybrid
    BA-GMRES (the JAX test's tolerances)."""
    gmres, gkb, rtol = pair
    out = _case(ranks, "gkb_deriv2")["equivalence"]
    np.testing.assert_allclose(out[gmres]["err_hist"], out[gkb]["err_hist"],
                               rtol=rtol)


@pytest.mark.parametrize("reg", ["correction", "full"])
def test_hybrid_lsmr_sharded_warm_start_matches_single_chip(ranks, deriv2,
                                                            reg):
    """x0 in both regularizer semantics against the JAX single-device run,
    the first 5 steps to rtol 1e-6 (the JAX test's band)."""
    A, b, xt, _, x0 = (jnp.asarray(v) for v in deriv2)
    ref = jhybrid_lsmr(A, b, xt, tol=0.0, maxit=10, lam=1e-3, x0=x0,
                       x0_reg=reg)
    got = _case(ranks, "gkb_deriv2")["hybrid_lsmr_x0"][reg]
    for name in ("err_hist", "res_hist"):
        np.testing.assert_allclose(got[name][:5], _j(getattr(ref, name))[:5],
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# GKB on panels (float32): 361, 435, 517, 584, 1439, 1488, 1513, 1552
# ---------------------------------------------------------------------------

def _f32(Ad, b, xt, f=jlsqr, **kw):
    return f(jnp.asarray(Ad), jnp.asarray(b), None if xt is None
             else jnp.asarray(xt), tol=0.0, **kw)


def test_lsqr_sharded_panels(ranks):
    """Sharded LSQR through K1 and K3 on each shard's forms (one panel, an
    exact adjoint pair) against the dense single-device LSQR: x to 1e-3,
    the error history to 2e-4; and through the resume path 6 -> 12, equal
    to the uninterrupted run to 1e-10."""
    out = _case(ranks, "gkb_panels")
    Ad, _, b, xt = cases.sparse_pair(64, 32, seed=4)
    ref = _f32(Ad, b, xt, maxit=10)
    np.testing.assert_allclose(out["lsqr"]["x"], _j(ref.x, np.float32),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(out["lsqr"]["err_hist"],
                               _j(ref.err_hist, np.float32), rtol=2e-4)
    r = out["resume"]
    np.testing.assert_allclose(r["resumed"]["res_hist"],
                               r["full"]["res_hist"], rtol=1e-10)
    np.testing.assert_allclose(r["resumed"]["x"], r["full"]["x"],
                               rtol=1e-10, atol=1e-12)


def test_lsqr_sharded_int8_panels(ranks):
    """The sharded LSQR half of test_parallel.py's int8 test: int8 panels
    (scales outside the kernel, the exact fro_sq) within 5% of the float
    solve's error history."""
    Ad, _, b, xt = cases.sparse_pair(64, 32, seed=6)
    ref = _f32(Ad, b, xt, maxit=8)
    np.testing.assert_allclose(_case(ranks, "gkb_panels")["int8"]["err_hist"],
                               _j(ref.err_hist, np.float32), rtol=0.05)


def test_lsqr_sharded_warm_start(ranks):
    """x0 on sharded LSQR/LSMR panels against the single-device warm
    starts (atol 5e-5), and a resumed warm LSQR 3 -> 6."""
    out = _case(ranks, "gkb_panels")["warm"]
    Ad, _, b, xt = cases.sparse_pair(64, 32, seed=23)
    x0 = jnp.asarray((np.random.default_rng(24).standard_normal(32) * 0.1
                      ).astype(np.float32))
    ref = _f32(Ad, b, xt, maxit=6, x0=x0)
    _close(out["lsqr"], ref, ("res_hist", "err_hist"), atol=5e-5)
    np.testing.assert_allclose(out["resumed"]["res_hist"],
                               out["lsqr"]["res_hist"], atol=5e-5)
    refm = _f32(Ad, b, xt, f=jlsmr, maxit=6, x0=x0)
    _close(out["lsmr"], refm, ("res_hist",), atol=5e-5)


def test_panels_with_adjoint_gkb_matches_dense(ranks):
    """PanelsWithAdjoint (K1 on a forward panel of A^T) reproduces the
    dense LSQR and hybrid-LSMR histories (atol 5e-5)."""
    out = _case(ranks, "gkb_panels")["adjoint"]
    Ad, _, b, xt = cases.sparse_pair(64, 32, seed=13)
    _close(out["lsqr"], _f32(Ad, b, xt, maxit=6), ("res_hist", "err_hist"),
           atol=5e-5)
    _close(out["hybrid_lsmr"], _f32(Ad, b, xt, f=jhybrid_lsmr, maxit=6,
                                    lam=1e-3), ("res_hist",), atol=5e-5)


def test_panels_with_adjoint_rejects_inexact_pairs():
    """Quantized or mixed-dtype pairs are not exact adjoints: an int8 A
    with a float AT demands ``build_panels_with_adjoint``, an int8 AT is
    refused, mixed float dtypes are refused; build_panels_with_adjoint
    refuses int4 — with the JAX package's messages."""
    Ad = cases.sparse_pair(64, 32, seed=13)[0]
    A_p = tpar.shard_bucketed_panels(sp.csr_matrix(Ad), P)
    AT = sp.csr_matrix(Ad.T.copy())
    bad = (
        ("shared-quantization", tpar.shard_bucketed_panels(
            sp.csr_matrix(Ad), P, dtype=np.int8),
         tpar.shard_bucketed_panels(AT, P)),
        ("quantized", A_p, tpar.shard_bucketed_panels(AT, P, dtype=np.int8)),
        ("storage dtypes differ", A_p, tpar.shard_bucketed_panels(
            AT, P, dtype=torch.bfloat16)))
    for msg, a, at in bad:
        with pytest.raises(ValueError, match=msg):
            tpar.PanelsWithAdjoint(a, at)
    with pytest.raises(ValueError, match="int4"):
        tpar.build_panels_with_adjoint(sp.csr_matrix(Ad), P, dtype="int4")
    with pytest.raises(ValueError, match="kind"):
        tpar.ComposedPanels(A_p, A_p, "xy")


def test_build_panels_with_adjoint_int8_shared_quantization(ranks):
    """One quantization A ~= diag(s) Q with AT holding raw Q^T: the pair's
    LSQR matches the dense solve on the exactly quantized operator and the
    transposed-kernel int8 path (atol 5e-5)."""
    out = _case(ranks, "gkb_panels")["adjoint_int8"]
    Ad, _, b, xt = cases.sparse_pair(64, 32, seed=19)
    csr_q, s8 = _row_quantize_csr(sp.csr_matrix(Ad), qmax=127)
    Aq = (s8[:, None] * csr_q.toarray()).astype(np.float32)
    _close(out["pair"], _f32(Aq, b, xt, maxit=6), ("res_hist",), atol=5e-5)
    np.testing.assert_allclose(out["pair"]["res_hist"],
                               out["transposed"]["res_hist"], atol=5e-5)


@pytest.mark.parametrize("kind", ["ab", "ba"])
def test_composed_panels_gkb_matches_product_operator(ranks, kind):
    """Sharded LSQR and hybrid LSQR over M = A B / B A from the two panel
    sets against the single-device solvers on the dense product
    (run_2D_phantom.m:150-176): histories rtol 2e-3 atol 1e-5, x rtol 1e-2
    atol 1e-4."""
    Ad, Bd, b, _ = cases.sparse_pair(64, 64, seed=9)
    Md = Ad @ Bd if kind == "ab" else Bd @ Ad
    rhs = b if kind == "ab" else (Bd @ b).astype(np.float32)
    out = _case(ranks, "gkb_panels")[f"composed {kind}"]
    for name, f, kw in (("lsqr", jlsqr, {}),
                        ("hybrid_lsqr", jhybrid_lsqr, {"lam": 1e-2})):
        ref = _f32(Md, rhs, None, f=f, maxit=8, **kw)
        _close(out[name], ref, ("res_hist",), np.float32, rtol=2e-3,
               atol=1e-5)
        _close(out[name], ref, ("x",), np.float32, rtol=1e-2, atol=1e-4)


def test_composed_panels_forward_b_matches_transposed(ranks):
    """ComposedPanels(B=...) applies B through K1 on its own pixel-row
    panel; the composed LSQR is unchanged (atol 5e-5)."""
    out = _case(ranks, "gkb_panels")["composed_forward"]
    for name in ("res_hist", "err_hist"):
        np.testing.assert_allclose(out["forward"][name],
                                   out["transposed"][name], atol=5e-5)


@pytest.mark.parametrize("shape", ["pair", "composed"])
def test_converted_panels_match_the_jax_solver(ranks, converted, shape):
    """PanelsWithAdjoint and ComposedPanels carried over from the JAX
    package's panels (``utils.convert``) give the JAX sharded LSQR's
    histories and x on make_mesh(4) (float32, atol 5e-5; x rtol 1e-3);
    the pair's LSQR makes one all_gather per half-step and no
    reduce_scatter."""
    got = _case(ranks, "gkb_panels")["converted"]
    ref = converted[1][shape]
    _close(got[shape], ref, ("res_hist", "err_hist"), atol=5e-5)
    np.testing.assert_allclose(got[shape]["x"], _j(ref.x), rtol=1e-3,
                               atol=1e-5)
    if shape == "pair":
        # the start, 2 a step, the patch and x: gathers; no reduce_scatter
        assert got["calls"][1] == 2 + 2 * 4 + 1 and got["calls"][2] == 0


# ---------------------------------------------------------------------------
# RTP: 769, 800, 1272
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["ba", "ab"])
def test_sharded_rtp_matches_single_device(ranks, kind):
    """Sharded RTP (Krylov on B A + lam I, the shift shard-diagonal; AB's
    Gram accumulated one fused all_reduce a step) against the JAX
    single-device RTP solver: histories rtol 2e-4 atol 1e-6, x rtol 1e-3
    atol 1e-5.  Per step 5 all_reduces for BA (2 CGS2, the norm, residual
    and error; AB one more for the Gram), one gather, one reduce_scatter."""
    got = _case(ranks, "rtp")[kind]
    Ad, Bd, b, xt = cases.sparse_pair(64, 32, seed=17)
    f = jba_rtp if kind == "ba" else jab_rtp
    ref = f(*(jnp.asarray(v) for v in (Ad, Bd, b, xt)), tol=0.0, maxit=8,
            lam=1e-2)
    _close(got, ref, ("res_hist", "err_hist"), np.float32, rtol=2e-4,
           atol=1e-6)
    _close(got, ref, ("x",), np.float32, rtol=1e-3, atol=1e-5)
    k = 8
    np.testing.assert_array_equal(
        got["calls"], [(4 + (kind == "ab")) * k + 3, k + 1, k + 1, 0])


def test_sharded_rtp_differs_from_ptr(ranks):
    """PTR != RTP (run_ptr_rtp_comparison.m) at scale too."""
    out = _case(ranks, "rtp")["vs_ptr"]
    d = np.nanmax(np.abs(out["rtp"]["err_hist"] - out["ptr"]["err_hist"]))
    assert d > 1e-4, d


@pytest.mark.parametrize("kind", ["ba", "ab"])
def test_forward_b_layout_rtp_matches_transposed(ranks, kind):
    """The RTP solvers with B through K1 on its own panels match the
    transposed layout to 5e-5."""
    out = _case(ranks, "rtp")[f"forward {kind}"]
    for name in ("res_hist", "err_hist"):
        np.testing.assert_allclose(out["forward"][name],
                                   out["transposed"][name], rtol=5e-5)


# ---------------------------------------------------------------------------
# Multi-RHS: 1663, 1696, 1725, 1760, 2037, 2094, 2348 and the primitives
# ---------------------------------------------------------------------------

def _jbatched(kind, seed, R=3, **kw):
    Ad, Bd, b, xt = cases.batched_pair(R=R, seed=seed)
    f = jba_batched if kind == "ba" else jab_batched
    return f(*(jnp.asarray(v) for v in (Ad, Bd, b, xt)), tol=0.0,
             chunk_rhs=None, **kw)


@pytest.mark.parametrize("kind", ["ba", "ab"])
@pytest.mark.parametrize("lam", [None, 1e-3])
def test_sharded_batched_matches_single_device(ranks, kind, lam):
    """Per RHS (R=3, gloo) the JAX single-device batched solver: histories
    atol 2e-5, x rtol 1e-3 atol 2e-5, niters equal."""
    got = _case(ranks, "batched")[f"{kind} {lam}"]
    ref = _jbatched(kind, 1, maxit=6, lam=lam)
    _close(got, ref, ("res_hist", "err_hist"), atol=2e-5)
    _close(got, ref, ("x",), rtol=1e-3, atol=2e-5)
    np.testing.assert_array_equal(got["niters"], _j(ref.niters))


@pytest.mark.parametrize("kind", ["ba", "ab"])
def test_sharded_batched_deferred_matches_in_loop(ranks, kind):
    """defer_histories reproduces the in-loop numbers (atol 1e-5), niters
    and the active flags."""
    out = _case(ranks, "batched")
    r1, r2 = out[f"{kind} 0.001"], out[f"{kind} deferred"]
    for name in ("res_hist", "err_hist"):
        np.testing.assert_allclose(r2[name], r1[name], atol=1e-5)
    np.testing.assert_allclose(r2["x"], r1["x"], rtol=1e-3, atol=1e-5)
    for name in ("niters", "active"):
        np.testing.assert_array_equal(r2[name], r1[name])


@pytest.mark.parametrize("kind", ["ba", "ab"])
def test_sharded_batched_collectives_do_not_depend_on_r(ranks, kind):
    """The collectives of a solve at R=3 are those at R=1: per step one
    gather for A, one reduce_scatter for B, 5 all_reduces (2 CGS2, the
    column norms, residual, error); 3 more all_reduces and (BA) one
    reduce_scatter at the start, one all_gather of x at the end."""
    counts = _case(ranks, "batched")[f"{kind} calls"]
    np.testing.assert_array_equal(counts[0], counts[1])
    k = 6
    np.testing.assert_array_equal(
        counts[0], [5 * k + 3, k + 1, k + (kind == "ba"), 0])


def test_sharded_batched_warm_start_and_chunking(ranks):
    """Per-RHS x0 with chunk_rhs=2 (R=5) against the unchunked JAX
    single-device warm start (atol 2e-5); warm beats cold at step 1."""
    out = _case(ranks, "batched")
    xt = cases.batched_pair(R=5, seed=4)[3]
    x0 = (xt + 0.1 * np.random.default_rng(9).standard_normal(xt.shape)
          ).astype(np.float32)
    ref = _jbatched("ba", 4, R=5, maxit=5, lam=1e-3, x0=jnp.asarray(x0))
    _close(out["warm"], ref, ("res_hist", "err_hist"), atol=2e-5)
    assert np.all(out["warm"]["err_hist"][0] < out["cold"]["err_hist"][0])


def test_sharded_batched_forward_b_and_wire_dtype(ranks):
    """B through K2 on its own panels reproduces the transposed layout
    (atol 2e-5), the bfloat16 wire stays within 3e-2, and a single RHS is
    refused."""
    out = _case(ranks, "batched")
    lay = out["layouts"]
    np.testing.assert_allclose(lay["forward"]["res_hist"],
                               lay["transposed"]["res_hist"], atol=2e-5)
    np.testing.assert_allclose(lay["bf16"]["res_hist"],
                               lay["transposed"]["res_hist"], atol=3e-2)
    assert "expects b of shape" in out["single_rhs"]


def test_sharded_batched_gcv_final_matches_single_chip(ranks):
    """lam='gcv-final' through the deferred path against the JAX
    single-device batched solver (atol 5e-5); in-loop it raises."""
    out = _case(ranks, "batched")
    ref = _jbatched("ba", 15, maxit=6, lam="gcv-final", defer_histories=True)
    _close(out["gcv_final"], ref, ("err_hist", "res_hist"), atol=5e-5)
    assert "gcv-final" in out["gcv_final_in_loop"]


@pytest.mark.parametrize("kind", ["ba", "ab"])
def test_sharded_batched_resume_equals_uninterrupted(ranks, kind):
    """Resume 4 -> 8 (R=5, x0, chunk_rhs=2) equals the uninterrupted run
    (atol 1e-6); a checkpoint of another x0, or a deferred resume,
    raises."""
    out = _case(ranks, "batched")
    r = out[f"resume {kind}"]
    for name in ("res_hist", "err_hist", "x"):
        np.testing.assert_allclose(r["resumed"][name], r["full"][name],
                                   atol=1e-6)
    assert "fingerprint" in out["resume_wrong_x0"]
    assert "defer" in out["resume_deferred"]


def test_sharded_batched_on_windowed_panels(ranks):
    """A windowed pair at p=4 (L=2 shifts) with R=3: the dense JAX batched
    solve's histories (atol 2e-5), the shifts of every gather carrying
    all 3 columns."""
    got = _case(ranks, "batched")["windowed"]
    Ad, Bd, b, xt = cases.banded_pair()
    ref = jba_batched(*(jnp.asarray(v) for v in (
        Ad.toarray(), Bd.toarray(), b, xt)), tol=0.0, maxit=6, lam=1e-3,
        chunk_rhs=None)
    _close(got, ref, ("res_hist", "err_hist"), atol=2e-5)
    dmin, L = tpar.shard_bucketed_panels(Ad, P).shifts
    nonzero = sum((dmin + i) % P != 0 for i in range(L))
    assert got["calls"][3] == 6 * nonzero > 0


def test_replica_fleet_composition(ranks):
    """make_replica_meshes(2) on 4 ranks: two 2-rank replicas, each an
    independent sharded batched solve of its 2 frames, per RHS the JAX
    single-device batched solve (atol 2e-5); 3 replicas are refused."""
    Ad, Bd, b, xt = cases.batched_pair(R=4, seed=27)
    seen = set()
    for out in ranks:
        got = out["fleet"]
        if "traceback" in got:
            pytest.fail(got["traceback"])
        rep = int(got["replica"])
        seen.add(rep)
        sl = slice(2 * rep, 2 * rep + 2)
        ref = jba_batched(*(jnp.asarray(v) for v in (Ad, Bd, b[:, sl],
                                                      xt[:, sl])),
                          tol=0.0, maxit=6, lam=1e-3, chunk_rhs=None)
        _close(got, ref, ("res_hist", "err_hist"), atol=2e-5)
        np.testing.assert_array_equal(got["sizes"], [2, 2])
        assert "replicas" in got["three"]
    assert seen == {0, 1}


@pytest.mark.parametrize("band", ["band", "upper"])
def test_multi_rhs_primitives_match_jax(ranks, band):
    """gather_window_mat / local_matmat / local_rmatmat_window /
    scatter_window_to_full_mat on windowed panels at p=4, R=3, against the
    JAX primitives in shard_map on make_mesh(4) (interpret mode) and the
    CSR products; the window comes back in the batched basis' layout and
    column j of every primitive equals its single-RHS twin bit for bit."""
    from hybrid_gmres_tpu.parallel.panels import (
        gather_window_mat, local_matmat, local_rmatmat_window,
        scatter_window_to_full_mat)

    offsets = (-40, 0, 40) if band == "band" else cases.UPPER_BAND
    Ad = cases.banded(P, 13, offsets=offsets)
    got = _case(ranks, "primitives")[band]
    jp = _jpanels(Ad)
    assert got["windowed"] and jp.windowed
    assert tuple(got["shifts"]) == tuple(jp.shifts)
    if band == "band":
        assert int(np.asarray(jp.win_start)[0]) < 0   # wraps below slab 0
    assert got["columns_equal"]
    assert got["window_strides"][0] == 1              # (win_len, R) of (R, .)
    rng = np.random.default_rng(13)
    X = rng.standard_normal((Ad.shape[1], 3)).astype(np.float32)
    U = rng.standard_normal((Ad.shape[0], 3)).astype(np.float32)
    mesh = jpar.make_mesh(P)

    def fwd(pan, X_loc):
        return local_matmat(pan, gather_window_mat(pan, X_loc, "rows"),
                            interpret=True)

    def rmv(pan, U_loc):
        return jax.lax.psum(scatter_window_to_full_mat(
            pan, local_rmatmat_window(pan, U_loc, interpret=True)), "rows")

    y = jax.shard_map(fwd, mesh=mesh, in_specs=(JP("rows"), JP("rows")),
                      out_specs=JP("rows"), check_vma=False)(jp,
                                                             jnp.asarray(X))
    z = jax.shard_map(rmv, mesh=mesh, in_specs=(JP("rows"), JP("rows")),
                      out_specs=JP(), check_vma=False)(jp, jnp.asarray(U))
    for mine, theirs, exact in ((got["Y"], y, Ad @ X), (got["Z"], z,
                                                        Ad.T @ U)):
        np.testing.assert_allclose(mine, _j(theirs), rtol=2e-5, atol=1e-5)
        np.testing.assert_allclose(mine, exact, rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["gkb_dense", "rtp", "batched"])
def test_results_replicated_on_every_rank(ranks, case):
    """Every rank returns the same replicated x and histories."""
    first = _case(ranks, case)
    for key, res in first.items():
        if not isinstance(res, dict) or "x" not in res:
            continue
        for other in ranks[1:]:
            for field in ("x", "res_hist", "err_hist"):
                np.testing.assert_array_equal(other[case][key][field],
                                              res[field], err_msg=key)
