"""PyTorch port: the 2-D (ray x pixel) tiled tier against the JAX package.

The port runs SPMD on 4 gloo ranks, spawned once for this file (the
``CASES_2D`` of ``tests/torch_parallel_cases.py``, which imports no JAX),
on the grids (2, 2), (4, 1) and (1, 4) in place of the JAX tests' (4, 2)
and (2, 4).  The tests mirror the 2-D cases of ``tests/test_parallel.py``
(its lines 483, 505, 864, 898, 928, 952, 973, 1107, 1590, 1799, 1836,
1871, 2137, 2186, 2217 and 2262), with their tolerances:

  * the dense 2-D solver in float64, rtol 1e-8 against the JAX
    single-device fused solve (the JAX test's oracle);
  * the tiled solvers in the JAX tests' float32 bands against the JAX
    single-device solvers (the JAX tests' own oracles), and once against
    the JAX tiled solver itself (Pallas in interpret mode) on tiles carried
    over by ``tiled_panels_from_numpy``.

In this process: the (1, 1) tile forms bit-equal to the 1-D p=1 forms, the
tile products summed over an axis against the whole operator's, the comms
model against the JAX one, and the ``__all__`` superset.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import hybrid_gmres_tpu.parallel as jpar
from hybrid_gmres_tpu import ab_gmres as jab_gmres
from hybrid_gmres_tpu import ba_gmres as jba_gmres
from hybrid_gmres_tpu.ops.spmv_pallas import _row_quantize_csr
from hybrid_gmres_tpu.solvers.batched import (
    ab_gmres_batched as jab_batched,
    ba_gmres_batched as jba_batched,
)
from hybrid_gmres_tpu.solvers.gmres import (
    ab_gmres_restarted as jab_restarted,
    ba_gmres_restarted as jba_restarted,
)
from hybrid_gmres_tpu.solvers.lsmr import hybrid_lsmr as jhybrid_lsmr
from hybrid_gmres_tpu.solvers.lsmr import lsmr as jlsmr
from hybrid_gmres_tpu.solvers.lsqr import hybrid_lsqr as jhybrid_lsqr
from hybrid_gmres_tpu.solvers.lsqr import lsqr as jlsqr

import hybrid_gmres_tpu_torch.parallel as tpar
import torch_parallel_cases as cases

GRIDS = cases.GRIDS
SQUARE = cases.SQUARE
F32 = dict(rtol=2e-4, atol=1e-6)


def _leaves(jt):
    """A JAX TiledPanels' leaves as the keywords of
    ``tiled_panels_from_numpy``."""
    return dict(
        buckets=[(np.asarray(b), np.asarray(c)) for b, c in jt.buckets],
        inv_perm=np.asarray(jt.inv_perm), shape=jt.shape,
        ncb_tile=jt.ncb_tile, row_group=jt.row_group, pr=jt.pr, pc=jt.pc,
        packed4=jt.packed4,
        row_scale=None if jt.row_scale is None else np.asarray(jt.row_scale),
        fro_sq=np.asarray(jt.fro_sq))


@pytest.fixture(scope="module")
def converted():
    """The JAX tiles of the seed-23 pair on (2, 2) (int8 A, float32 B^T),
    their leaves, and the JAX tiled BA solve on them (interpret mode)."""
    Ad, Bd, b, xt = cases.sparse_pair(64, 32, seed=23)
    A_t = jpar.tile_bucketed_panels(sp.csr_matrix(Ad), *SQUARE,
                                    dtype=np.int8)
    BT_t = jpar.tile_bucketed_panels(sp.csr_matrix(Bd.T), *SQUARE)
    ref = jpar.ba_gmres_sharded_pallas_2d(
        A_t, BT_t, jnp.asarray(b), jnp.asarray(xt), tol=0.0, maxit=6,
        lam=1e-3, mesh=jpar.make_mesh_2d(SQUARE), interpret=True)
    return (_leaves(A_t), _leaves(BT_t)), ref


@pytest.fixture(scope="module")
def ranks(converted):
    """Every rank's results of every 2-D case (one spawn for the file)."""
    return cases.spawn({"converted_2d": converted[0]}, group="2d")


def _case(ranks, name):
    out = ranks[0][name]
    if isinstance(out, dict) and "traceback" in out:
        pytest.fail(out["traceback"])
    return out


def _j(v, dtype=None):
    return np.asarray(v, dtype=dtype)


def _close(got, ref, names, dtype=None, **tol):
    for name in names:
        np.testing.assert_allclose(got[name], _j(getattr(ref, name), dtype),
                                   err_msg=name, **tol)


def _pair(seed):
    Ad, Bd, b, xt = cases.sparse_pair(64, 32, seed=seed)
    return tuple(jnp.asarray(v) for v in (Ad, Bd, b, xt))


@pytest.fixture(scope="module")
def refs():
    """The JAX single-device solves, each made once for the file."""
    return {}


def _ref(refs, fn, seed, **kw):
    """The JAX single-device solve ``fn`` on the seed's pair (A, B or A
    alone for the GKB family), from ``refs`` or made there."""
    key = (fn, seed, tuple(sorted(kw.items())))
    if key not in refs:
        Ad, Bd, b, xt = _pair(seed)
        ops = (Ad,) if fn in (jlsqr, jlsmr, jhybrid_lsqr, jhybrid_lsmr) \
            else (Ad, Bd)
        refs[key] = fn(*ops, b, xt, **kw)
    return refs[key]


# ---------------------------------------------------------------------------
# The mesh's per-axis groups
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", GRIDS)
def test_mesh_axis_groups(ranks, grid):
    """Rank (i, j) = i * pc + j sums over "rows" with the ranks of its
    column and over "cols" with those of its row; each axis counts its own
    calls."""
    pr, pc = grid
    for rank, out in enumerate(ranks):
        got = _case([out], "mesh_axes")[str(grid)]
        i, j = divmod(rank, pc)
        col = [r * pc + j for r in range(pr)]
        row = [i * pc + c for c in range(pc)]
        assert list(got["coords"]) == [i, j]
        assert got["ranks"] == [col, row]
        assert list(got["index"]) == [i, j]
        np.testing.assert_array_equal(got["sums"], [sum(col), sum(row)])
        np.testing.assert_array_equal(got["calls"], [1, 1, 0])


def test_mesh_2d_device_rules(ranks):
    got = _case(ranks, "mesh_axes")
    assert got["cuda"] == "RuntimeError"
    assert "no axis" in got["no_axis"]


# ---------------------------------------------------------------------------
# The dense 2-D solver (float64): test_parallel.py 483, 505, 952
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("lam", [None, 1e-3])
def test_dense_2d_matches_single_device(ranks, refs, grid, lam):
    """The JAX test's oracle: the single-device fused solve, float64."""
    key = ("dense", lam)
    if key not in refs:
        refs[key] = jba_gmres(*(jnp.asarray(v) for v in cases.dense_prob()),
                              tol=1e-10, maxit=16, lam=lam, residual="fused")
    ref = refs[key]
    got = _case(ranks, "dense_2d")[f"{grid} {lam}"]
    np.testing.assert_allclose(got["x"], _j(ref.x), rtol=1e-9, atol=1e-12)
    _close(got, ref, ("err_hist", "res_hist"), rtol=1e-8)
    assert int(got["niters"]) == int(ref.niters)


def test_dense_2d_requires_divisible_and_mesh(ranks):
    got = _case(ranks, "dense_2d")
    assert "must divide" in got["divisible"]
    assert "2-D mesh" in got["no_mesh"]


def test_dense_2d_adaptive_gcv(ranks, refs):
    ref = _ref(refs, jba_gmres, 26, tol=0.0, maxit=6, lam="gcv",
               gcv_grid=tuple(np.logspace(-6, -1, 12)))
    _close(_case(ranks, "dense_2d")["gcv"], ref, ("err_hist",), np.float32,
           **F32)


# ---------------------------------------------------------------------------
# Tiled BA/AB: test_parallel.py 864, 898, 928
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("kind", ["ba", "ab"])
def test_tiled_2d_matches_dense(ranks, refs, kind, grid):
    ref = _ref(refs, jba_gmres if kind == "ba" else jab_gmres, 23, tol=0.0,
               maxit=8, lam=1e-3)
    got = _case(ranks, "tiled")[f"{kind} {grid}"]
    _close(got, ref, ("res_hist", "err_hist"), np.float32, **F32)
    np.testing.assert_allclose(got["x"], _j(ref.x, np.float32), rtol=2e-3,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_tiled_2d_quantized(ranks, dtype):
    """One global per-row quantization shared by the tiles: the solve
    matches the dense run on the exactly quantized operator."""
    Ad, Bd, b, xt = cases.sparse_pair(64, 32, seed=24)
    q, s = _row_quantize_csr(sp.csr_matrix(Ad),
                             qmax=7 if dtype == "int4" else 127)
    Aq = jnp.asarray(s[:, None] * q.toarray(), dtype=jnp.float32)
    ref = jba_gmres(Aq, jnp.asarray(Bd), jnp.asarray(b), jnp.asarray(xt),
                    tol=0.0, maxit=6, lam=1e-3)
    _close(_case(ranks, "tiled")[dtype], ref, ("res_hist", "err_hist"),
           np.float32, **F32)


def test_tiled_2d_adaptive_gcv(ranks, refs):
    ref = _ref(refs, jba_gmres, 25, tol=0.0, maxit=6, lam="gcv",
               gcv_grid=tuple(np.logspace(-6, -1, 12)))
    _close(_case(ranks, "tiled")["gcv"], ref, ("err_hist",), np.float32,
           **F32)


def test_tiled_2d_converted_matches_jax(ranks, converted):
    """JAX tiles carried over leaf by leaf (padded buckets, int8 scales)
    give the port's solver the JAX tiled solver's histories."""
    _close(_case(ranks, "converted"), converted[1],
           ("res_hist", "err_hist"), **F32)


# ---------------------------------------------------------------------------
# The forward B layout: test_parallel.py 1590
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("kind", ["ba", "ab"])
def test_tiled_2d_forward_b_layout(ranks, refs, kind, grid):
    ref = _ref(refs, jba_gmres if kind == "ba" else jab_gmres, 29, tol=0.0,
               maxit=6, lam=1e-3)
    np.testing.assert_allclose(
        _case(ranks, "forward")[f"{kind} {grid}"]["res_hist"],
        _j(ref.res_hist), atol=5e-5)


def test_tiled_2d_forward_b_int8_and_wrong_grid(ranks):
    Ad, Bd, b, xt = cases.sparse_pair(64, 32, seed=29)
    q, s = _row_quantize_csr(sp.csr_matrix(Bd), qmax=127)
    Bq = jnp.asarray(s[:, None] * q.toarray(), dtype=jnp.float32)
    ref = jba_gmres(jnp.asarray(Ad), Bq, jnp.asarray(b), jnp.asarray(xt),
                    tol=0.0, maxit=6, lam=1e-3)
    got = _case(ranks, "forward")
    np.testing.assert_allclose(got["int8"]["res_hist"], _j(ref.res_hist),
                               atol=5e-5)
    assert "B tiles" in got["wrong_grid"]


# ---------------------------------------------------------------------------
# Warm start, resume, restarted: test_parallel.py 1799, 1836, 1871
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["ba", "ab"])
def test_tiled_2d_warm_start(ranks, kind):
    Ad, Bd, b, xt = _pair(11)
    x0 = (np.asarray(xt) + 0.2 * np.random.default_rng(3).standard_normal(
        32)).astype(np.float32)
    ref = (jba_gmres if kind == "ba" else jab_gmres)(
        Ad, Bd, b, xt, tol=0.0, maxit=6, lam=1e-3, x0=jnp.asarray(x0))
    got = _case(ranks, "gmres_modes")[f"x0 {kind}"]
    _close(got, ref, ("res_hist", "err_hist"), np.float32, rtol=5e-5,
           atol=1e-6)
    np.testing.assert_allclose(got["x"], _j(ref.x, np.float32), rtol=1e-3,
                               atol=1e-5)


@pytest.mark.parametrize("kind", ["ba", "ab"])
def test_tiled_2d_resume_equals_uninterrupted(ranks, kind):
    got = _case(ranks, "gmres_modes")[f"resume {kind}"]
    full, resumed = got["full"], got["resumed"]
    for name in ("res_hist", "err_hist"):
        np.testing.assert_allclose(resumed[name], full[name], rtol=2e-5)
    np.testing.assert_allclose(resumed["x"], full["x"], rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("kind", ["ba", "ab"])
def test_tiled_2d_restarted(ranks, kind):
    Ad, Bd, b, xt = _pair(13)
    ref = (jba_restarted if kind == "ba" else jab_restarted)(
        Ad, Bd, b, xt, tol=1e-10, restart=4, max_restarts=2, lam=1e-3)
    _close(_case(ranks, "gmres_modes")[f"restarted {kind}"], ref,
           ("res_hist", "err_hist"), np.float32, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# GKB: test_parallel.py 1107, 2186
# ---------------------------------------------------------------------------

GKB_BAND = dict(rtol=2e-3, atol=1e-5)


@pytest.mark.parametrize("grid", GRIDS)
def test_gkb_2d_matches_single_device(ranks, refs, grid):
    got = _case(ranks, "gkb")
    kw = dict(tol=0.0, maxit=10)
    ref = _ref(refs, jlsqr, 41, **kw)
    _close(got[f"lsqr {grid}"], ref, ("res_hist",), np.float32, **GKB_BAND)
    np.testing.assert_allclose(got[f"lsqr {grid}"]["x"],
                               _j(ref.x, np.float32), rtol=1e-2, atol=1e-4)
    _close(got[f"hybrid_lsqr {grid}"], _ref(refs, jhybrid_lsqr, 41, lam=1e-2,
                                            **kw),
           ("res_hist",), np.float32, **GKB_BAND)
    ref = _ref(refs, jlsmr, 41, **kw)
    _close(got[f"lsmr {grid}"], ref, ("res_hist",), np.float32, **GKB_BAND)
    _close(got[f"lsmr {grid}"], ref, ("ar_hist",), np.float32, rtol=5e-3,
           atol=1e-5)
    for lam in (1e-2, "gcv"):
        _close(got[f"hybrid_lsmr {lam} {grid}"],
               _ref(refs, jhybrid_lsmr, 41, lam=lam, **kw), ("err_hist",),
               np.float32, **GKB_BAND)


@pytest.mark.parametrize("name", ["lsqr", "lsmr", "hybrid_lsmr",
                                  "hybrid_lsqr"])
def test_gkb_2d_reorth(ranks, refs, name):
    """reorth=True: u-space CGS2 sums over "rows", v-space over "cols" (the
    hybrid LSQR's augmented u-space over both, on the square grid)."""
    ref_f, kw = {"lsqr": (jlsqr, {}), "lsmr": (jlsmr, {}),
                 "hybrid_lsmr": (jhybrid_lsmr, {"lam": 1e-2}),
                 "hybrid_lsqr": (jhybrid_lsqr, {"lam": 1e-2})}[name]
    ref = _ref(refs, ref_f, 41, tol=0.0, maxit=10, reorth=True, **kw)
    _close(_case(ranks, "gkb")[f"reorth {name}"], ref,
           ("res_hist", "err_hist"), np.float32, **GKB_BAND)


@pytest.mark.parametrize("name", ["lsqr", "lsmr", "hybrid_lsqr",
                                  "hybrid_lsmr", "hybrid_lsmr full"])
def test_gkb_2d_x0(ranks, name):
    """test_parallel.py 2217: the single-chip warm starts (hybrid LSMR under
    both regularizer semantics)."""
    Ad, _, b, xt = _pair(41)
    x0 = jnp.asarray((np.asarray(xt) + 0.2 * np.random.default_rng(
        7).standard_normal(32)).astype(np.float32))
    ref_f, kw = {"lsqr": (jlsqr, {}), "lsmr": (jlsmr, {}),
                 "hybrid_lsqr": (jhybrid_lsqr, {"lam": 1e-2}),
                 "hybrid_lsmr": (jhybrid_lsmr, {"lam": 1e-2}),
                 "hybrid_lsmr full": (jhybrid_lsmr, {"lam": 1e-2,
                                                     "x0_reg": "full"})}[name]
    ref = ref_f(Ad, b, xt, tol=0.0, maxit=8, x0=x0, **kw)
    got = _case(ranks, "gkb_modes")[f"x0 {name}"]
    _close(got, ref, ("res_hist", "err_hist"), np.float32, rtol=2e-3,
           atol=2e-5)
    np.testing.assert_allclose(got["x"], _j(ref.x, np.float32), rtol=1e-2,
                               atol=1e-4)


@pytest.mark.parametrize("name", ["lsqr", "lsmr", "hybrid_lsqr"])
def test_gkb_2d_resume_equals_uninterrupted(ranks, name):
    """test_parallel.py 2262: resume(run(4), 8) == run(8) exactly, with and
    without reorth; a reorth mismatch and a changed x0 are refused."""
    got = _case(ranks, "gkb_modes")
    for reorth in (False, True):
        full, resumed = (got[f"resume {name} {reorth}"][k]
                         for k in ("full", "resumed"))
        for key in full:
            np.testing.assert_array_equal(resumed[key], full[key],
                                          err_msg=key)
    assert "reorth" in got[f"resume {name} reorth mismatch"]
    assert "fingerprint" in got[f"resume {name} x0 changed"]


# ---------------------------------------------------------------------------
# The serving batch: test_parallel.py 2137
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["ba", "ab"])
def test_batched_2d_matches_single_device(ranks, kind):
    Ad, Bd, b, xt = (jnp.asarray(v) for v in cases.batched_pair(seed=31))
    x0 = jnp.asarray((np.asarray(xt) + 0.1 * np.random.default_rng(
        2).standard_normal(xt.shape)).astype(np.float32))
    ref = (jba_batched if kind == "ba" else jab_batched)(
        Ad, Bd, b, xt, tol=0.0, maxit=6, lam=1e-3, chunk_rhs=None, x0=x0)
    got = _case(ranks, "batched")
    _close(got[kind], ref, ("res_hist", "err_hist"), atol=2e-5)
    np.testing.assert_allclose(got[kind]["x"], _j(ref.x), rtol=1e-3,
                               atol=2e-5)
    deferred = got[f"{kind} deferred"]
    np.testing.assert_allclose(deferred["err_hist"], got[kind]["err_hist"],
                               atol=1e-5)
    np.testing.assert_array_equal(deferred["niters"], got[kind]["niters"])
    if kind == "ba":
        np.testing.assert_allclose(got["ba forward"]["res_hist"],
                                   got["ba"]["res_hist"], atol=2e-5)


def test_batched_2d_collectives_independent_of_r(ranks):
    got = _case(ranks, "batched")
    np.testing.assert_array_equal(got["calls R=3"], got["calls R=1"])


# ---------------------------------------------------------------------------
# The dry run (the JAX dryrun_multichip's tiers), on the 4 ranks
# ---------------------------------------------------------------------------

def test_dryrun_multichip(ranks):
    for out in ranks:
        got = _case([out], "dryrun")
        assert len(got["tags"]) == 27
        assert "lsqr_sharded_2d[reorth+x0+resume]" in got["tags"]
        assert got["wrong_size"] == "RuntimeError"


# ---------------------------------------------------------------------------
# In this process: forms, tile products, the comms model, the exports
# ---------------------------------------------------------------------------

def _same_forms(a, b):
    return all(torch.equal(getattr(fa, f), getattr(fb, f))
               for fa, fb in ((a.fwd_rows, b.fwd_rows),
                              (a.adj_rows, b.adj_rows))
               for f in ("vals", "cols", "vec_off", "row_map")) and (
        (a.row_scale is None and b.row_scale is None)
        or torch.equal(a.row_scale, b.row_scale))


@pytest.mark.parametrize("dtype", [np.float32, np.int8, "int4"])
def test_tiles_1x1_bit_equal_to_1d_forms(dtype):
    """At (1, 1) the tile of A and the forward tile of B hold the 1-D p=1
    shard's forms and scales, bit for bit."""
    Ad, Bd, _, _ = cases.sparse_pair(64, 32, seed=23)
    for csr, tiles in (
            (Ad, tpar.tile_bucketed_panels(sp.csr_matrix(Ad), 1, 1,
                                           dtype=dtype)),
            (Bd, tpar.tile_backprojector_forward(sp.csr_matrix(Bd), 1, 1,
                                                 dtype=dtype))):
        one = tpar.shard_bucketed_panels(sp.csr_matrix(csr), 1, dtype=dtype)
        assert _same_forms(tiles.tiles[0], one.shards[0])
        np.testing.assert_array_equal(tiles.fro_sq.numpy(),
                                      one.fro_sq.numpy())


@pytest.mark.parametrize("grid", [(2, 2), (4, 2)])
@pytest.mark.parametrize("dtype", [np.float32, np.int8, "int4"])
def test_tile_products_sum_to_the_operator(grid, dtype):
    """Each tile's unscaled partials (K1r/K3r, and K2r/K4r whose column j is
    K1r/K3r's on column j), summed over the axis and scaled as the solvers
    do, give the products of the whole (quantized) operator; the forward B
    tile of mesh rank (i, j) is B[pixel slab j, ray slab i]."""
    from hybrid_gmres_tpu_torch.parallel.panels2d import (
        tile_matmat, tile_matvec, tile_rmatmat, tile_rmatvec, tile_view)

    pr, pc = grid
    Ad, Bd, _, _ = cases.sparse_pair(64, 32, seed=5)
    csr = sp.csr_matrix(Ad)
    if dtype != np.float32:
        q, s = _row_quantize_csr(csr, qmax=7 if dtype == "int4" else 127)
        Ad = (s[:, None] * q.toarray()).astype(np.float32)
    m, n = Ad.shape
    mloc, nloc = m // pr, n // pc
    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.standard_normal((n, 3)), dtype=torch.float32)
    U = torch.as_tensor(rng.standard_normal((m, 3)), dtype=torch.float32)
    tp = tpar.tile_bucketed_panels(csr, pr, pc, dtype=dtype)
    Y = torch.zeros((m, 3))
    Z = torch.zeros((n, 3))
    for i in range(pr):
        for j in range(pc):
            v = tile_view(tp, i, j)
            scale = v.tiles[0].row_scale
            Xj, Ui = X[j * nloc:(j + 1) * nloc], U[i * mloc:(i + 1) * mloc]
            Yp, Zp = tile_matmat(v, Xj), tile_rmatmat(v, Ui, scale)
            for c in range(3):
                assert torch.equal(Yp[:, c], tile_matvec(v, Xj[:, c]))
                assert torch.equal(Zp[:, c],
                                   tile_rmatvec(v, Ui[:, c], scale))
            Y[i * mloc:(i + 1) * mloc] += Yp
            Z[j * nloc:(j + 1) * nloc] += Zp
    s = tp.tiles[0].row_scale
    if s is not None:      # the scales of row slab i, on every tile of it
        Y *= torch.cat([tp.local(i, 0).row_scale for i in range(pr)])[:, None]
    np.testing.assert_allclose(Y.numpy(), Ad @ X.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(Z.numpy(), Ad.T @ U.numpy(), rtol=1e-5,
                               atol=1e-5)
    Bt = tpar.tile_backprojector_forward(sp.csr_matrix(Bd), pr, pc)
    for i in range(pr):
        for j in range(pc):
            u = U[i * mloc:(i + 1) * mloc, 0]
            np.testing.assert_allclose(
                tile_matvec(tile_view(Bt, i, j), u).numpy(),
                Bd[j * nloc:(j + 1) * nloc, i * mloc:(i + 1) * mloc]
                @ u.numpy(), rtol=1e-5, atol=1e-5)


def test_tiled_2d_comms_model_and_compression():
    """The comms dict is the JAX one, falls in both mesh dimensions and
    below the 1-D full-gather floor; the tiles' forms stay compressed."""
    rng = np.random.default_rng(30)
    n = 1024
    diags = [rng.standard_normal(n - abs(o)) for o in (-40, 0, 40)]
    Ad = sp.diags(diags, offsets=(-40, 0, 40)).tocsr().astype(np.float32)
    got = {}
    for grid in ((4, 2), (2, 4)):
        t = tpar.tile_bucketed_panels(Ad, *grid)
        got[grid] = tpar.comms_bytes_per_iteration_2d(t)
        assert got[grid] == jpar.comms_bytes_per_iteration_2d(
            jpar.tile_bucketed_panels(Ad, *grid))
        assert t.nbytes <= 0.55 * n * n * 4
    assert got[(4, 2)]["A_reduce_bytes"] < got[(2, 4)]["A_reduce_bytes"]
    assert got[(4, 2)]["B_reduce_bytes"] > got[(2, 4)]["B_reduce_bytes"]
    c1d = tpar.comms_bytes_per_iteration(
        tpar.shard_bucketed_panels(Ad, 8, window=False))
    assert got[(4, 2)]["total_bytes"] < c1d["total_bytes"]


def test_parallel_all_covers_jax():
    assert set(jpar.__all__) <= set(tpar.__all__)
