"""PyTorch port: the single-RHS GKB solvers (LSQR, hybrid LSQR, LSMR, hybrid
LSMR) against the JAX package.

The same numpy inputs go through both packages, in float64 on dense
operators where the algorithm is the point and in float32 through the int8
block-ELL operators (forward panels only: the JAX side runs its transposed
Pallas kernel in interpret mode, the port K3's plain version) for the slice
as a whole.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hybrid_gmres_tpu.problems import onedim as jonedim
from hybrid_gmres_tpu.utils import checkpoint as jckpt
from hybrid_gmres_tpu_torch.ops.linear_operator import LinearOperator
from hybrid_gmres_tpu_torch.utils import checkpoint as tckpt
from hybrid_gmres_tpu_torch.utils.convert import (
    gkb_result_from_numpy,
    gkb_state_from_numpy,
)

# the solver packages export functions under their modules' names
jlsqr = importlib.import_module("hybrid_gmres_tpu.solvers.lsqr")
jlsmr = importlib.import_module("hybrid_gmres_tpu.solvers.lsmr")
tlsqr = importlib.import_module("hybrid_gmres_tpu_torch.solvers.lsqr")
tlsmr = importlib.import_module("hybrid_gmres_tpu_torch.solvers.lsmr")

SOLVERS = {
    "lsqr": (jlsqr.lsqr, tlsqr.lsqr, {}),
    "hybrid_lsqr": (jlsqr.hybrid_lsqr, tlsqr.hybrid_lsqr, {"lam": 1e-3}),
    "lsmr": (jlsmr.lsmr, tlsmr.lsmr, {}),
    "hybrid_lsmr": (jlsmr.hybrid_lsmr, tlsmr.hybrid_lsmr, {"lam": 1e-3}),
}
NAMES = list(SOLVERS)
FIELDS = ("x", "res_hist", "err_hist", "ar_hist", "niters")

# Float64 on both sides, the same recurrences, other summation orders in
# the products.  With full reorthogonalization the differences stay near
# 1e-15 over 14 steps (heat, n=40).  The short recurrences alone amplify
# them as orthogonality is lost: 3e-12 after 6 steps, 1e-8 after 8 and 1e-3
# after 14, so those runs are compared over 6 steps.
RTOL_REORTH, RTOL_SHORT, SHORT_STEPS = 1e-10, 1e-8, 6


def _problem(name="heat", n=40, noise=1e-3, seed=0):
    A, b, x = (np.asarray(a) for a in jonedim.generate_test_problem(
        name, n, dtype=jnp.float64))
    e = np.random.default_rng(seed).standard_normal(n)
    return A, b + noise * np.linalg.norm(b) / np.linalg.norm(e) * e, x


def _run(name, A, b, x, **kw):
    """The same call in both packages: (JAX result, port result)."""
    jfn, tfn, base = SOLVERS[name]
    kw = {**base, **kw}
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    jr = jfn(jnp.asarray(A), jnp.asarray(b),
             None if x is None else jnp.asarray(x), **jkw)
    tr = tfn(torch.from_numpy(A), torch.from_numpy(b),
             None if x is None else torch.from_numpy(x), **tkw)
    return jr, tr


def _tol_between(name, A, b, x):
    """(tol, k): a tolerance that stops solver ``name`` at step k, halfway
    in the logarithm between two residuals that differ by over 10% (the
    regularized residuals level off early)."""
    tfn, base = SOLVERS[name][1:]
    res = tfn(torch.from_numpy(A), torch.from_numpy(b), torch.from_numpy(x),
              tol=0.0, maxit=12, reorth=True, **base).state.res_hist.numpy()
    k = max(j for j in range(1, 8) if res[j] < 0.9 * res[:j].min())
    return float(np.sqrt(res[:k].min() * res[k])), k + 1


def _assert_match(jr, tr, rtol, fields=FIELDS):
    for f in fields:
        want, got = getattr(jr, f), getattr(tr, f)
        if want is None:
            assert got is None, f
            continue
        want, got = np.asarray(want), got.numpy()
        assert want.shape == got.shape, f
        np.testing.assert_array_equal(np.isnan(want), np.isnan(got), f)
        scale = np.nanmax(np.abs(want)) if want.size else 1.0
        np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale,
                                   equal_nan=True, err_msg=f)


def _assert_identical(a, b):
    """Two port results, bit for bit, carries included."""
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x.numpy(), y.numpy(), f)
    for i, (c, d) in enumerate(zip(a.state.carry, b.state.carry)):
        assert (c is None) == (d is None), i
        if c is not None:
            np.testing.assert_array_equal(c.numpy(), d.numpy(), f"carry {i}")
    for f in ("res_hist", "err_hist", "fp"):
        np.testing.assert_array_equal(getattr(a.state, f).numpy(),
                                      getattr(b.state, f).numpy(), f)


@pytest.mark.parametrize("reorth", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_solver_matches_jax(name, reorth):
    """x, the histories, niters and the carry's shapes at tol=0: 14 steps
    with ``reorth``, 6 with the short recurrences."""
    A, b, x = _problem()
    maxit = 14 if reorth else SHORT_STEPS
    jr, tr = _run(name, A, b, x, tol=0.0, maxit=maxit, reorth=reorth)
    assert int(tr.niters) == maxit and tr.niters.dtype == torch.int32
    _assert_match(jr, tr, RTOL_REORTH if reorth else RTOL_SHORT)
    assert len(tr.state.carry) == len(jr.state.carry)
    for c, d in zip(jr.state.carry, tr.state.carry):
        assert (c is None) == (d is None)
        if c is not None:
            assert tuple(np.shape(c)) == tuple(d.shape)
    np.testing.assert_array_equal(np.asarray(jr.state.fp),
                                  tr.state.fp.numpy())


@pytest.mark.parametrize("name,extra", [
    ("lsqr", {}), ("hybrid_lsqr", {}), ("lsmr", {}),
    ("hybrid_lsmr", {"x0_reg": "correction"}),
    ("hybrid_lsmr", {"x0_reg": "full"})])
def test_warm_start_matches_jax(name, extra):
    """``x0``: correction space for LSQR/LSMR, the exact augmented restart
    for hybrid LSQR, both regularizer semantics for hybrid LSMR."""
    A, b, x = _problem()
    x0 = x + 0.05 * np.random.default_rng(1).standard_normal(len(x))
    jr, tr = _run(name, A, b, x, tol=0.0, maxit=10, x0=x0, reorth=True,
                  **extra)
    _assert_match(jr, tr, RTOL_REORTH)
    assert float(tr.err_hist[0]) < 0.3      # it did start from x0
    np.testing.assert_allclose(tr.state.fp.numpy(), np.asarray(jr.state.fp),
                               rtol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_tolerance_stops_early_like_jax(name):
    """tol > 0: the same niters < maxit, NaN beyond it, the carry frozen."""
    A, b, x = _problem()
    tol, k = _tol_between(name, A, b, x)
    jr, tr = _run(name, A, b, x, tol=tol, maxit=12, reorth=True)
    assert int(tr.niters) == int(jr.niters) == k
    assert np.isnan(tr.res_hist.numpy()[int(tr.niters):]).all()
    _assert_match(jr, tr, RTOL_REORTH)


@pytest.mark.parametrize("kind", ["zero_rhs", "rank_deficient"])
@pytest.mark.parametrize("name", NAMES)
def test_breakdown_freezes_like_jax(name, kind):
    """A zero right-hand side adopts nothing (niters 0, all NaN, no wrapped
    patch index); on diag(1, 1, 0, 0) with b = e1 the second GKB vector is
    exactly zero: breakdown at the first step.  The loop runs on and records
    NaN, as the JAX scan does."""
    A = np.diag([1.0, 1.0, 0.0, 0.0])
    b = np.zeros(4) if kind == "zero_rhs" else np.eye(4)[0]
    x = np.eye(4)[0]
    jr, tr = _run(name, A, b, x, tol=0.0, maxit=3)
    assert int(tr.niters) == int(jr.niters) == 0
    assert np.isnan(tr.res_hist.numpy()).all()
    _assert_match(jr, tr, 1e-12)


@pytest.mark.parametrize("opts", [
    {"rank1_mode": "first"}, {"rank1_mode": "last"}, {"lam": "gcv"},
    {"lam": "gcv", "gcv_grid": np.logspace(-6, 0, 13)},
    {"lam": 0.37, "reorth": True}])
def test_hybrid_lsmr_options_match_jax(opts):
    """Both rank-1 modes, the per-iteration GCV lambda on the default and on
    a custom grid (argmin over a grid: the same lambda unless two values
    tie), a large lambda."""
    A, b, x = _problem("shaw", noise=1e-2)
    jr, tr = _run("hybrid_lsmr", A, b, x, tol=0.0, maxit=8,
                  **{"reorth": True, **opts})
    _assert_match(jr, tr, 1e-7)
    for bad in ({"rank1_mode": "middle"}, {"x0_reg": "none"},
                {"lam": "lcurve"}):
        with pytest.raises(ValueError):
            tlsmr.hybrid_lsmr(torch.from_numpy(A), torch.from_numpy(b),
                              maxit=2, **bad)


def test_hybrid_lsmr_stale_alpha_at_the_final_iteration():
    """The reference reports its final iteration with the previous alpha:
    the last history entry of run(K) differs from entry K-1 of run(K+1),
    while every earlier entry agrees exactly, in both packages."""
    A, b, x = _problem("shaw", noise=1e-2)
    kw = dict(tol=0.0, lam=1e-3)
    r6 = tlsmr.hybrid_lsmr(torch.from_numpy(A), torch.from_numpy(b),
                           torch.from_numpy(x), maxit=6, **kw)
    r7 = tlsmr.hybrid_lsmr(torch.from_numpy(A), torch.from_numpy(b),
                           torch.from_numpy(x), maxit=7, **kw)
    np.testing.assert_array_equal(r6.res_hist[:5].numpy(),
                                  r7.res_hist[:5].numpy())
    assert float(r6.res_hist[5]) != float(r7.res_hist[5])
    j6 = jlsmr.hybrid_lsmr(jnp.asarray(A), jnp.asarray(b), jnp.asarray(x),
                           maxit=6, **kw)
    np.testing.assert_allclose(r6.res_hist.numpy(), np.asarray(j6.res_hist),
                               rtol=1e-6)


@pytest.mark.parametrize("x0", [False, True])
@pytest.mark.parametrize("reorth", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_resume_equals_uninterrupted_exactly(name, reorth, x0):
    """resume(run(maxit=5), maxit=12) == run(maxit=12) bit for bit on the
    CPU: histories (LSQR's patched after the resume), x, niters, the carry
    with its grown bases and the fingerprint."""
    A, b, x = _problem("shaw", noise=1e-2)
    kw = dict(tol=0.0, reorth=reorth)
    if x0:
        kw["x0"] = torch.from_numpy(0.9 * x)
        if name == "hybrid_lsmr":
            kw["x0_reg"] = "full"
    tfn, base = SOLVERS[name][1:]
    args = (torch.from_numpy(A), torch.from_numpy(b), torch.from_numpy(x))
    part = tfn(*args, maxit=5, **base, **kw)
    before = [None if c is None else c.clone() for c in part.state.carry]
    full = tfn(*args, maxit=12, **base, **kw)
    resumed = tfn(*args, maxit=12, resume_from=part.state, **base, **kw)
    _assert_identical(resumed, full)
    for c, d in zip(before, part.state.carry):   # the checkpoint is intact
        if c is not None:
            np.testing.assert_array_equal(c.numpy(), d.numpy())


def test_resume_of_a_stopped_run_stays_stopped():
    """A run that met its tolerance resumes inactive: NaN beyond niters."""
    A, b, x = _problem()
    args = (torch.from_numpy(A), torch.from_numpy(b), torch.from_numpy(x))
    for name in NAMES:
        tfn, base = SOLVERS[name][1:]
        tol, k = _tol_between(name, A, b, x)
        kw = dict(tol=tol, reorth=True, **base)
        part = tfn(*args, maxit=10, **kw)
        assert int(part.niters) == k
        _assert_identical(tfn(*args, maxit=14, resume_from=part.state, **kw),
                          tfn(*args, maxit=14, **kw))


@pytest.mark.parametrize("via", ["convert", "npz"])
@pytest.mark.parametrize("name", NAMES)
def test_resume_of_a_jax_state_matches_jax(name, via, tmp_path):
    """A state made by the JAX package (maxit=5, reorth) continues in the
    port to maxit=11 and gives the JAX package's uninterrupted run, handed
    over through ``gkb_state_from_numpy`` or through the ``.npz`` that the
    JAX ``save_gkb_state`` writes; the port's own ``.npz`` loads back in
    both packages."""
    A, b, x = _problem("shaw", noise=1e-2)
    jfn, tfn, base = SOLVERS[name]
    kw = dict(tol=0.0, reorth=True, **base)
    jargs = (jnp.asarray(A), jnp.asarray(b), jnp.asarray(x))
    targs = (torch.from_numpy(A), torch.from_numpy(b), torch.from_numpy(x))
    jpart = jfn(*jargs, maxit=5, **kw)
    jfull = jfn(*jargs, maxit=11, **kw)
    if via == "convert":
        state = gkb_state_from_numpy(jpart.state, device="cpu")
        whole = gkb_result_from_numpy(jpart, device="cpu")
        assert whole.niters.dtype == torch.int32
        assert len(whole.state.carry) == len(jpart.state.carry)
    else:
        path = str(tmp_path / "jax_state.npz")
        jckpt.save_gkb_state(path, jpart.state)
        state = tckpt.load_gkb_state(path, device="cpu")
    assert state.carry[7 if "lsqr" in name else (
        12 if name == "lsmr" else 6)].dtype == torch.bool
    tr = tfn(*targs, maxit=11, resume_from=state, **kw)
    _assert_match(jfull, tr, 1e-7)
    if via == "npz":
        # and back: the port's file in the JAX package and in the port
        mine = str(tmp_path / "port_state.npz")
        tpart = tfn(*targs, maxit=5, **kw)
        tckpt.save_gkb_state(mine, tpart.state)
        jr = jfn(*jargs, maxit=11, resume_from=jckpt.load_gkb_state(mine),
                 **kw)
        _assert_match(jr, tr, 1e-7)
        again = tckpt.load_gkb_state(mine, device="cpu")
        _assert_identical(tfn(*targs, maxit=11, resume_from=again, **kw),
                          tfn(*targs, maxit=11, resume_from=tpart.state,
                              **kw))


def test_resume_guards():
    """A resume with another lam, x0, x0_reg or reorth, or with no larger
    budget, raises instead of continuing a different solve."""
    A, b, x = _problem()
    args = (torch.from_numpy(A), torch.from_numpy(b), torch.from_numpy(x))
    x0 = torch.from_numpy(0.5 * x)
    part = tlsqr.hybrid_lsqr(*args, maxit=4, lam=1e-3, tol=0.0)
    with pytest.raises(ValueError, match="fingerprint"):
        tlsqr.hybrid_lsqr(*args, maxit=8, lam=1e-2, resume_from=part.state)
    with pytest.raises(ValueError, match="fingerprint"):
        tlsqr.hybrid_lsqr(*args, maxit=8, lam=1e-3, x0=x0,
                          resume_from=part.state)
    with pytest.raises(ValueError, match="maxit > 4"):
        tlsqr.hybrid_lsqr(*args, maxit=4, lam=1e-3, resume_from=part.state)
    with pytest.raises(ValueError, match="reorth"):
        tlsqr.hybrid_lsqr(*args, maxit=8, lam=1e-3, reorth=True,
                          resume_from=part.state)
    full = tlsmr.hybrid_lsmr(*args, maxit=4, x0=x0, x0_reg="full", tol=0.0)
    with pytest.raises(ValueError, match="fingerprint"):
        tlsmr.hybrid_lsmr(*args, maxit=8, x0=x0, x0_reg="correction",
                          resume_from=full.state)
    with pytest.raises(ValueError, match="reorth"):
        tlsmr.hybrid_lsmr(*args, maxit=8, x0=x0, x0_reg="full", reorth=True,
                          resume_from=full.state)
    with pytest.raises(ValueError, match="reorth"):
        tlsmr.lsmr(*args, maxit=8, resume_from=tlsmr.lsmr(
            *args, maxit=4, reorth=True, tol=0.0).state)
    with pytest.raises(ValueError, match="cannot be combined"):
        tlsqr.hybrid_lsqr(*args, maxit=4, x0=x0, error_map=lambda z: z)


def test_hybrid_lsqr_error_map_matches_jax():
    """``error_map``: the error of a mapped iterate (x = M z)."""
    A, b, x = _problem()
    M = np.diag(np.linspace(0.5, 1.5, len(x)))
    jr = jlsqr.hybrid_lsqr(jnp.asarray(A), jnp.asarray(b), jnp.asarray(x),
                           tol=0.0, maxit=6, lam=1e-3,
                           error_map=lambda z: jnp.asarray(M) @ z)
    tr = tlsqr.hybrid_lsqr(torch.from_numpy(A), torch.from_numpy(b),
                           torch.from_numpy(x), tol=0.0, maxit=6, lam=1e-3,
                           error_map=lambda z: torch.from_numpy(M) @ z)
    _assert_match(jr, tr, RTOL_SHORT)


@pytest.mark.parametrize("source", ["recorded", "dense", "matrix_free",
                                    "argument"])
def test_lsmr_fro_norm_sources(source):
    """``ar_hist`` divides by ``||A||_F``: the operator's recorded value
    first, then a dense ``.mat``, then NaN for a matrix-free operator; an
    explicit ``fro_norm`` wins."""
    A, b, x = _problem(n=20)
    tA = torch.from_numpy(A)

    class Free(LinearOperator):
        shape, dtype, device = tA.shape, tA.dtype, tA.device

        def matvec(self, v):
            return tA @ v

        def rmatvec(self, u):
            return tA.T @ u

    class Recorded(Free):
        fro_norm = torch.tensor(2.0 * np.linalg.norm(A))

    op = {"recorded": Recorded(), "dense": tA, "matrix_free": Free(),
          "argument": Recorded()}[source]
    kw = {"fro_norm": 4.0 * np.linalg.norm(A)} if source == "argument" else {}
    r = tlsmr.lsmr(op, torch.from_numpy(b), torch.from_numpy(x), tol=0.0,
                   maxit=5, **kw)
    ref = np.asarray(jlsmr.lsmr(jnp.asarray(A), jnp.asarray(b),
                                jnp.asarray(x), tol=0.0, maxit=5).ar_hist)
    if source == "matrix_free":
        assert np.isnan(r.ar_hist.numpy()).all()
        assert np.isfinite(r.res_hist.numpy()).all()
    else:
        factor = {"recorded": 2.0, "dense": 1.0, "argument": 4.0}[source]
        np.testing.assert_allclose(factor * r.ar_hist.numpy(), ref,
                                   rtol=1e-6)


def _ct16_pairs():
    from hybrid_gmres_tpu.problems import ct as jct
    from hybrid_gmres_tpu_torch.problems import ct as tct

    jp = jct.ct_mismatched(n=16, n_angles=24, n_det=24, dense=False)
    jA, _, jb, jx, _, _ = jct.ct_tpu_operators(jp, dtype=jnp.int8)
    jA.interpret = True
    tp = tct.ct_mismatched(n=16, n_angles=24, n_det=24)
    tA, _, tb, tx, _, _ = tct.ct_gpu_operators(tp, dtype="int8",
                                               device="cpu")
    assert jA.adj is None and tA.adj is None
    return jA, jb, jx, tA, tb, tx


@pytest.mark.parametrize("name", NAMES)
def test_gkb_slice_ct16_int8_forward_panels_matches_jax(name):
    """The slice as a whole: CT n=16 (24x24 rays), int8 block-ELL operators
    with forward panels only, float32 vectors, 6 steps.  The JAX side
    applies ``A^T`` through its transposed Pallas kernel (interpret mode),
    the port through K3's plain version.  rtol 2e-4 of the largest entry:
    float32 recurrences whose products sum in different orders, amplified
    over 6 GKB steps (the products themselves agree to 1e-6)."""
    jA, jb, jx, tA, tb, tx = _ct16_pairs()
    jfn, tfn, base = SOLVERS[name]
    kw = dict(tol=0.0, maxit=6, **base)
    f32 = jnp.float32
    jr = jfn(jA, jb.astype(f32), jx.astype(f32), **kw)
    tr = tfn(tA, tb.float(), tx.float(), **kw)
    assert int(tr.niters) == int(jr.niters) == 6
    assert tr.x.dtype == torch.float32
    _assert_match(jr, tr, 2e-4)
    if name == "lsmr":      # the recorded ||A||_F made ar_hist real
        assert np.isfinite(tr.ar_hist.numpy()).all()
