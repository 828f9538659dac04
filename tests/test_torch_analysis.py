"""PyTorch port: ``analysis/filter_factors.py`` and ``utils/profiling.py``.

The filter-factor functions are host numpy/scipy code in both packages:
given the same Krylov factorization ``(Q, H)`` (the JAX package's, as numpy
arrays) they agree to 1e-12.  ``run_with_bounds`` end to end: the port's
solve on the CPU in float64 against the JAX package's, then the bounds of
each (hybrid variants to 1e-8; measured 1e-13).  The profiling helpers time
CPU callables here; on the card they wait for CUDA work (``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from hybrid_gmres_tpu.analysis import filter_factors as jff
from hybrid_gmres_tpu.problems import (
    add_noise,
    generate_test_problem,
    perturb_backprojector,
)
from hybrid_gmres_tpu.solvers.gmres import ab_gmres, ba_gmres
from hybrid_gmres_tpu_torch.analysis import filter_factors as tff
from hybrid_gmres_tpu_torch.utils import profiling

N = 16
LAM = 1e-3


@pytest.fixture(scope="module")
def shaw():
    """shaw n=16, 1e-3 noise, B = A^T + 1e-4 E, as the filter-factor
    driver builds it; returns host float64 arrays."""
    A, b_exact, x_true = generate_test_problem("shaw", N)
    b, _ = add_noise(b_exact, 1e-3, seed=0)
    B, E = perturb_backprojector(A, 1e-4, seed=0)
    return tuple(np.asarray(a, np.float64) for a in (A, B, b, x_true, E))


def _skip_on_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the error raised without a CUDA device")


def _delta(variant, A, E):
    return A @ E if variant == "ab" else E @ A


@pytest.mark.parametrize("variant", ["ab", "ba"])
@pytest.mark.parametrize("lam", [None, LAM])
def test_bounds_from_the_same_factorization(shaw, variant, lam):
    """Both packages' ``filter_bounds_from_factorization`` on the JAX
    solve's (Q, H): every k's filter factors and perturbation bounds to
    1e-12 of their largest entry."""
    A, B, b, x_true, E = shaw
    solver = ab_gmres if variant == "ab" else ba_gmres
    res = solver(A, B, b, x_true, tol=1e-6, maxit=N, lam=lam)
    M = A @ B if variant == "ab" else B @ A
    args = (variant, lam is not None, np.asarray(res.Q), np.asarray(res.H),
            int(res.niters), M)
    kw = dict(DeltaM=_delta(variant, A, E), lam=0.0 if lam is None else lam)
    want = jff.filter_bounds_from_factorization(*args, **kw)
    got = tff.filter_bounds_from_factorization(*args, **kw)
    assert len(got.phi_iter) == len(want.phi_iter) == int(res.niters)
    for field in ("phi_iter", "dphi_iter"):
        for k, (g, w) in enumerate(zip(getattr(got, field),
                                       getattr(want, field))):
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-12 * np.abs(w).max(),
                                       err_msg=f"{field} k={k + 1}")
    np.testing.assert_array_equal(got.phi_final, got.phi_iter[-1])


def test_spectral_setup_and_empirical_factors(shaw):
    A, B, b, x_true, E = shaw
    M, D = B @ A, _delta("ba", A, E)
    for g, w in zip(tff.spectral_setup(M, D), jff.spectral_setup(M, D)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12 * np.abs(w).max())
    mu, U, dmu = tff.spectral_setup(M)
    assert np.all(np.diff(mu) <= 0) and not dmu.any()
    np.testing.assert_allclose(tff.empirical_filter_factors(A, b, x_true),
                               jff.empirical_filter_factors(A, b, x_true),
                               rtol=1e-12)


@pytest.mark.parametrize("variant", ["ab", "ba"])
def test_run_with_bounds_matches_jax(shaw, variant):
    """The hybrid solve and its bounds end to end: histories over the
    first 12 steps to 1e-8, every k's factors and bounds to 1e-8 of their
    largest entry; the port's result lives on the device it was asked for,
    its Q and H read back as float64."""
    A, B, b, x_true, E = shaw
    D = _delta(variant, A, E)
    jres, jb = jff.run_with_bounds(variant, A, B, b, x_true, tol=1e-6,
                                   maxit=N, lam=LAM, DeltaM=D)
    tres, tb = tff.run_with_bounds(
        variant, torch.tensor(A), torch.tensor(B), torch.tensor(b),
        torch.tensor(x_true), tol=1e-6, maxit=N, lam=LAM, DeltaM=D,
        device="cpu")
    assert tres.x.device.type == "cpu" and tres.x.dtype == torch.float64
    assert int(tres.niters) == int(jres.niters)
    np.testing.assert_allclose(tres.err_hist.numpy()[:12],
                               np.asarray(jres.err_hist)[:12], rtol=1e-8)
    for field in ("phi_iter", "dphi_iter"):
        for g, w in zip(getattr(tb, field), getattr(jb, field)):
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-8 * np.abs(w).max())


def test_run_with_bounds_takes_numpy_and_runs_nonhybrid(shaw):
    """numpy inputs solve in float64 on the device named; without ``lam``
    the non-hybrid pencil is used (no lambda shift)."""
    A, B, b, x_true, _ = shaw
    res, bounds = tff.run_with_bounds("ab", A, B, b, x_true, tol=1e-6,
                                      maxit=6, device="cpu")
    assert res.x.dtype == torch.float64 and int(res.niters) == 6
    want = jff.filter_bounds_from_factorization(
        "ab", False, res.Q.numpy(), res.H.numpy(), 6, A @ B)
    for g, w in zip(bounds.phi_iter, want.phi_iter):
        np.testing.assert_array_equal(g, w)
    assert not np.any(bounds.dphi_final)


def test_run_with_bounds_defaults_to_the_card(shaw):
    A, B, b, x_true, _ = shaw
    _skip_on_a_card()
    with pytest.raises(RuntimeError, match="CUDA"):
        tff.run_with_bounds("ba", A, B, b, x_true, maxit=4)


def test_benchmark_times_cpu_work():
    x = torch.ones(128, dtype=torch.float64)
    calls = []

    def f(v):
        calls.append(1)
        return (v * v).sum()

    out = profiling.benchmark(f, x, iters=2, warmup=1)
    assert out["best_s"] > 0 and len(out["times"]) == 2
    assert out["best_s"] <= out["mean_s"] and len(calls) == 3
    calls.clear()
    assert len(profiling.benchmark(f, x, iters=3, warmup=0)["times"]) == 3
    assert len(calls) == 3
    tp = profiling.spmv_throughput(1000, 0.001)
    assert tp["nnz_per_s"] == 1e6 and tp["gb_per_s"] == 1000 * 8 / 1e-3 / 1e9


def test_device_seconds_times_cpu_work():
    """Per-call seconds of a CPU callable grow with its work; a callable
    that returns no tensor needs ``device=``."""
    M = torch.as_tensor(np.random.default_rng(0).standard_normal((256, 256)))

    def work(x, steps):
        for _ in range(steps):
            x = torch.tanh(M @ x)
        return x

    x = torch.ones(256, dtype=torch.float64)
    t1 = profiling.device_seconds(work, x, 20, repeats=5)
    t2 = profiling.device_seconds(work, x, 200, repeats=5)
    assert 0 < t1 < t2
    with pytest.raises(ValueError, match="no tensor"):
        profiling.device_seconds(lambda: None, repeats=2)
    assert profiling.device_seconds(lambda: None, repeats=2,
                                    device="cpu") >= 0
    assert profiling.result_device({"a": [x], "b": None}).type == "cpu"


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with profiling.device_trace(str(tmp_path), device="cpu") as prof:
        torch.ones(64).sum()
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert len(prof.key_averages()) > 0


def test_device_trace_defaults_to_the_card(tmp_path):
    _skip_on_a_card()
    with pytest.raises(RuntimeError, match="CUDA"):
        with profiling.device_trace(str(tmp_path)):
            pass
