"""PyTorch port: the lambda selectors (GCV curve, surface and Brent
minimization, the discrepancy principle, the L-curve sweep) against the
JAX package.

Float64 on the CPU, the same seeded numpy inputs to both packages (shaw
n=16, 1% noise, B = A^T + 1e-4 E, as the reference's
``analyze_regularization.m``).  GCV values are compared at rtol 1e-9 (the
convention of ``tests/test_torch_reg.py``), Brent's lambda at 1e-6
relative, a grid selection exactly, the L-curve norms at 1e-8.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hybrid_gmres_tpu.reg import discrepancy as jdisc
from hybrid_gmres_tpu.reg import gcv as jgcv
from hybrid_gmres_tpu.reg import lcurve as jlc
from hybrid_gmres_tpu_torch.ops.linear_operator import DenseOperator
from hybrid_gmres_tpu_torch.reg import discrepancy as tdisc
from hybrid_gmres_tpu_torch.reg import gcv as tgcv
from hybrid_gmres_tpu_torch.reg import lcurve as tlc

RTOL = 1e-9
GRID = np.logspace(-8, -1, 15)


def _problem(n=16, seed=0):
    """shaw n, 1% noise, B = A^T + 1e-4 E; also the noise norm."""
    from hybrid_gmres_tpu.problems import generate_test_problem

    A, b_exact, x_true = (np.asarray(a) for a in
                          generate_test_problem("shaw", n))
    rng = np.random.default_rng(seed)
    e = rng.standard_normal(n)
    e = 1e-2 * np.linalg.norm(b_exact) * e / np.linalg.norm(e)
    B = A.T + 1e-4 * rng.standard_normal((n, n))
    return A, B, b_exact + e, x_true, float(np.linalg.norm(e))


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.array(a)) for a in arrays])


@pytest.mark.parametrize("gcv_type", ["ab", "ba"])
@pytest.mark.parametrize("space", ["projected", "original"])
def test_gcv_curve_matches_jax(gcv_type, space):
    """GCV(lam) on a grid at k=8 from one factorization, both numerators."""
    (jA, jB, jb), (tA, tB, tb) = _both(_problem()[:3])
    want = np.asarray(jgcv.gcv_curve(gcv_type, jA, jB, jb, 8, GRID,
                                     residual_space=space))
    got = tgcv.gcv_curve(gcv_type, tA, tB, tb, 8, GRID, residual_space=space)
    assert got.shape == (len(GRID),)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


@pytest.mark.parametrize("gcv_type", ["ab", "ba"])
def test_gcv_surface_matches_jax(gcv_type):
    """GCV(k, lam) for k = 1..10 from one Arnoldi, and the per-k argmin."""
    (jA, jB, jb), (tA, tB, tb) = _both(_problem()[:3])
    js, jp = jgcv.gcv_surface(gcv_type, jA, jB, jb, range(1, 11), GRID)
    ts, tp = tgcv.gcv_surface(gcv_type, tA, tB, tb, range(1, 11), GRID)
    assert ts.shape == (len(GRID), 10)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("gcv_type", ["ab", "ba"])
@pytest.mark.parametrize("space", ["projected", "original"])
def test_gcv_lambda_matches_jax(gcv_type, space):
    """Brent on [1e-9, 1e-1] (fminbnd parity), k_gcv=12.  Brent stops on
    a bracket of ~1e-8 relative, but where the objective is flat to its
    rounding the two packages' last-bit differences steer it to other
    points of the flat bottom: measured on this problem up to 2.5e-6
    relative at k_gcv=6-10 and <= 1.8e-7 at 12, where the bottom is
    sharper."""
    (jA, jB, jb), (tA, tB, tb) = _both(_problem()[:3])
    jlam, jval = jgcv.gcv_lambda(gcv_type, jA, jB, jb, k_gcv=12,
                                 residual_space=space)
    tlam, tval = tgcv.gcv_lambda(gcv_type, tA, tB, tb, k_gcv=12,
                                 residual_space=space)
    assert isinstance(tlam, float) and 1e-9 <= tlam <= 1e-1
    np.testing.assert_allclose(tlam, jlam, rtol=1e-6)
    np.testing.assert_allclose(tval, jval, rtol=1e-6)


@pytest.mark.parametrize("case", ["interior", "at_bound", "kink"])
def test_minimize_scalar_bounded_matches_jax(case):
    """The host Brent minimizer is the JAX package's, step for step, and
    finds the minimum."""
    f, lo, hi, xmin = {
        "interior": (lambda x: (x - 0.3) ** 2 + 1.0, 0.0, 1.0, 0.3),
        "at_bound": (lambda x: x, 1e-9, 1e-1, 1e-9),
        "kink": (lambda x: abs(x - 0.71) + 0.1 * x, 0.0, 2.0, 0.71),
    }[case]
    got = tgcv.minimize_scalar_bounded(f, lo, hi)
    assert got == jgcv.minimize_scalar_bounded(f, lo, hi)
    np.testing.assert_allclose(got[0], xmin, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("variant", ["ab", "ba"])
@pytest.mark.parametrize("delta_scale", [1.0, 1e-6])
def test_discrepancy_lambda_matches_jax(variant, delta_scale):
    """The largest grid lambda fitting the data to tau * delta (delta = the
    noise norm), and the smallest-residual fallback when delta is far too
    optimistic; the residual curve at rtol 1e-9."""
    A, B, b, _, delta = _problem()
    (jA, jB, jb), (tA, tB, tb) = _both((A, B, b))
    jlam, jinfo = jdisc.discrepancy_lambda(variant, jA, jB, jb,
                                           delta * delta_scale, k=10)
    tlam, tinfo = tdisc.discrepancy_lambda(variant, tA, tB, tb,
                                           delta * delta_scale, k=10)
    assert float(tlam) == float(jlam)
    np.testing.assert_allclose(tinfo["res"].numpy(), np.asarray(jinfo["res"]),
                               rtol=RTOL)
    np.testing.assert_array_equal(tinfo["feasible"].numpy(),
                                  np.asarray(jinfo["feasible"]))
    assert int(tinfo["nsteps"]) == int(jinfo["nsteps"])
    assert bool(tinfo["feasible"].any()) == (delta_scale == 1.0)


@pytest.mark.parametrize("variant", ["ab", "ba"])
def test_lcurve_sweep_matches_jax(variant):
    """The sweep of the hybrid PTR solver over 6 lambdas, maxit=6: residual,
    solution and error norms, and the error-optimal lambda.  The grid goes
    down to 1e-10, where the solve is all but unregularized and amplifies
    the packages' rounding differences with every step (measured 4e-8 on
    the error norm at maxit=8, 6e-11 at 6)."""
    A, B, b, x_true, _ = _problem()
    (jA, jB, jb, jx), (tA, tB, tb, tx) = _both((A, B, b, x_true))
    grid = np.logspace(-10, 0, 6)
    js = jlc.lcurve_sweep(variant, jA, jB, jb, jx, grid, maxit=6)
    ts = tlc.lcurve_sweep(variant, tA, tB, tb, tx, grid, maxit=6)
    for name in ("res_norms", "sol_norms", "err_norms", "err_min"):
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)), rtol=1e-8,
                                   err_msg=name)
    assert float(ts.lam_true_opt) == float(js.lam_true_opt)
    np.testing.assert_array_equal(ts.lam_grid.numpy(), grid)


def test_original_space_takes_one_product_of_the_basis():
    """BA's original-space numerator ``R = A Q_k`` is one multi-RHS product
    of the column-major basis (on the card: one K2 launch at R = k_gcv);
    AB's ``R = Q Hbar`` takes none."""
    A, B, b, _, _ = _problem()
    calls = []

    class Recording(DenseOperator):
        def matmat(self, X):
            calls.append((tuple(X.shape), X.stride(0)))
            return super().matmat(X)

    A_op = Recording(torch.from_numpy(A))
    tgcv.gcv_lambda("ba", A_op, torch.from_numpy(B), torch.from_numpy(b),
                    k_gcv=10, residual_space="original")
    assert calls == [((16, 10), 1)]
    tgcv.gcv_lambda("ab", A_op, torch.from_numpy(B), torch.from_numpy(b),
                    k_gcv=10, residual_space="original")
    assert len(calls) == 1


@pytest.mark.parametrize("call", ["gcv_type", "residual_space", "variant"])
def test_bad_selector_arguments_raise_like_jax(call):
    A, B, b, _, _ = _problem()
    for pkg, (a, bb, rhs), gcv, disc in (
            ("jax", _both((A, B, b))[0], jgcv, jdisc),
            ("port", _both((A, B, b))[1], tgcv, tdisc)):
        with pytest.raises(ValueError):
            {"gcv_type": lambda: gcv.gcv_curve("xy", a, bb, rhs, 4, GRID),
             "residual_space": lambda: gcv.gcv_lambda(
                 "ba", a, bb, rhs, k_gcv=4, residual_space="data"),
             "variant": lambda: disc.discrepancy_lambda(
                 "xy", a, bb, rhs, 1.0)}[call]()


def test_lcurve_optimum_skips_nan_errors(monkeypatch):
    """A NaN final error (a float32 Cholesky of H'H + lam I that failed at a
    tiny lambda) is not the error-optimal lambda."""
    A, B, b, x_true, _ = _problem()
    solve = tlc.ba_gmres

    def nan_at_small_lam(*args, lam, **kw):
        r = solve(*args, lam=lam, **kw)
        if lam < 1e-8:
            r = r._replace(err_hist=torch.full_like(r.err_hist,
                                                    float("nan")))
        return r

    monkeypatch.setattr(tlc, "ba_gmres", nan_at_small_lam)
    ts = tlc.lcurve_sweep("ba", torch.from_numpy(A), torch.from_numpy(B),
                          torch.from_numpy(b), torch.from_numpy(x_true),
                          np.logspace(-10, 0, 6), maxit=6)
    assert torch.isnan(ts.err_norms[0])
    assert float(ts.lam_true_opt) >= 1e-8 and torch.isfinite(ts.err_min)
    assert float(ts.err_min) == float(ts.err_norms[1:].min())
