"""PyTorch port: Krylov pieces and the GMRES solvers against the JAX package.

Float64 on the CPU, same numpy inputs to both packages.  Histories are
compared over the first 8 iterations at rtol 1e-10: the two packages run the
same algorithm with different BLAS summation orders, and later iterations
drift physically on ill-conditioned problems.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hybrid_gmres_tpu.krylov.arnoldi import arnoldi_orthogonalize as jorth
from hybrid_gmres_tpu.krylov import projected as jproj
from hybrid_gmres_tpu.solvers import gmres as jgmres
from hybrid_gmres_tpu.utils.checkpoint import resume_fingerprint as jfp
from hybrid_gmres_tpu_torch.krylov import projected as tproj
from hybrid_gmres_tpu_torch.solvers import gmres as tgmres
from hybrid_gmres_tpu_torch.utils.checkpoint import resume_fingerprint as tfp
from hybrid_gmres_tpu_torch.utils.convert import dense_from_numpy

# the module: the package exports the function ``arnoldi`` under its name
tarn = importlib.import_module("hybrid_gmres_tpu_torch.krylov.arnoldi")

RTOL = 1e-10
K = 8  # iterations compared


def _pair(m=40, n=24, seed=0):
    """A mismatched pair like __graft_entry__.dryrun_multichip's."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) * 0.1 + np.eye(m, n)
    B = A.T + 1e-4 * rng.standard_normal((n, m))
    x_true = rng.standard_normal(n)
    b = A @ x_true + 1e-3 * rng.standard_normal(m)
    return A, B, b, x_true


def _compare(jr, tr, k=K):
    for name in ("res_hist", "err_hist"):
        want = np.asarray(getattr(jr, name))[:k]
        np.testing.assert_allclose(getattr(tr, name).numpy()[:k], want,
                                   rtol=RTOL, err_msg=name)
    assert int(tr.niters) == int(jr.niters)
    np.testing.assert_array_equal(np.isnan(getattr(tr, "res_hist").numpy()),
                                  np.isnan(np.asarray(jr.res_hist)))


@pytest.mark.parametrize("method", ["ba", "ab"])
@pytest.mark.parametrize("lam", [None, 1e-3])
@pytest.mark.parametrize("residual", ["true", "fused", "estimate"])
def test_gmres_matches_jax(method, lam, residual):
    A, B, b, x_true = _pair()
    jsolve = getattr(jgmres, f"{method}_gmres")
    tsolve = getattr(tgmres, f"{method}_gmres")
    jr = jsolve(jnp.asarray(A), jnp.asarray(B), jnp.asarray(b),
                jnp.asarray(x_true), tol=0.0, maxit=K, lam=lam,
                residual=residual)
    tr = tsolve(dense_from_numpy(A, device="cpu"),
                dense_from_numpy(B, device="cpu"),
                torch.from_numpy(b), torch.from_numpy(x_true), tol=0.0,
                maxit=K, lam=lam, residual=residual)
    _compare(jr, tr)
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=RTOL,
                               atol=RTOL * np.abs(np.asarray(jr.x)).max())
    np.testing.assert_allclose(tr.H.numpy(), np.asarray(jr.H), rtol=RTOL,
                               atol=1e-13)
    np.testing.assert_array_equal(tr.fp.numpy(), np.asarray(jr.fp))


@pytest.mark.parametrize("method", ["ba", "ab"])
def test_gmres_x0_matches_jax(method):
    A, B, b, x_true = _pair(seed=1)
    x0 = 0.5 * x_true
    jr = getattr(jgmres, f"{method}_gmres")(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(b), jnp.asarray(x_true),
        tol=0.0, maxit=K, lam=1e-3, x0=jnp.asarray(x0), residual="fused")
    tr = getattr(tgmres, f"{method}_gmres")(
        torch.from_numpy(A), torch.from_numpy(B), torch.from_numpy(b),
        torch.from_numpy(x_true), tol=0.0, maxit=K, lam=1e-3,
        x0=torch.from_numpy(x0), residual="fused")
    _compare(jr, tr)
    # cosine-weighted x0 checksum: float32 cos in two libraries
    np.testing.assert_allclose(tr.fp.numpy(), np.asarray(jr.fp), rtol=1e-5)


def test_stop_on_tolerance_masks_like_jax():
    """tol stop: niters, the NaN tail and the adopted x match."""
    A, B, b, x_true = _pair(m=30, n=12, seed=2)
    kw = dict(tol=1e-2, maxit=12, lam=None, residual="true")
    jr = jgmres.ba_gmres(jnp.asarray(A), jnp.asarray(B), jnp.asarray(b),
                         jnp.asarray(x_true), **kw)
    tr = tgmres.ba_gmres(torch.from_numpy(A), torch.from_numpy(B),
                         torch.from_numpy(b), torch.from_numpy(x_true), **kw)
    assert 0 < int(jr.niters) < 12
    _compare(jr, tr, k=int(jr.niters))
    assert not bool(tr.active) and not bool(jr.active)
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=1e-9)


def test_breakdown_adopts_exact_solution_like_jax():
    """An invariant Krylov space (M = I, so the first step breaks down)
    adopts the exact projected solve and stops, as the JAX rule does."""
    n = 6
    A = np.eye(n)
    b = np.arange(1.0, n + 1)
    kw = dict(tol=0.0, maxit=4, lam=None, residual="true")
    jr = jgmres.ba_gmres(jnp.asarray(A), jnp.asarray(A), jnp.asarray(b),
                         jnp.asarray(b), **kw)
    tr = tgmres.ba_gmres(torch.from_numpy(A), torch.from_numpy(A),
                         torch.from_numpy(b), torch.from_numpy(b), **kw)
    assert int(tr.niters) == int(jr.niters) == 1
    _compare(jr, tr, k=1)
    np.testing.assert_allclose(tr.x.numpy(), b, rtol=1e-12)


def test_arnoldi_and_projected_solves_match_jax():
    rng = np.random.default_rng(3)
    n, maxit, k = 30, 6, 3
    Q = np.zeros((n, maxit + 1))
    Q[:, :k + 1] = np.linalg.qr(rng.standard_normal((n, k + 1)))[0]
    H = np.zeros((maxit + 1, maxit))
    H[:k + 1, :k] = np.triu(rng.standard_normal((k + 1, k)), -1)
    w = rng.standard_normal(n)
    js = jorth(jnp.asarray(Q), jnp.asarray(H), k, jnp.asarray(w))
    Qt, Ht = torch.from_numpy(Q.copy()), torch.from_numpy(H.copy())
    ts = tarn.arnoldi_orthogonalize(Qt, Ht, k, torch.from_numpy(w))
    assert ts.Q is Qt and ts.H is Ht          # written in place
    np.testing.assert_allclose(Qt.numpy(), np.asarray(js.Q), atol=1e-14)
    np.testing.assert_allclose(Ht.numpy(), np.asarray(js.H), atol=1e-14)
    # an inactive step leaves both columns untouched
    Q2, H2 = torch.from_numpy(Q.copy()), torch.from_numpy(H.copy())
    tarn.arnoldi_orthogonalize(Q2, H2, k, torch.from_numpy(w),
                               active=torch.tensor(False))
    np.testing.assert_array_equal(Q2.numpy(), Q)
    np.testing.assert_array_equal(H2.numpy(), H)

    Hk, t = np.array(js.H), np.zeros(maxit + 1)
    t[0] = 1.7
    for kdim in (1, k + 1):
        np.testing.assert_allclose(
            tproj.projected_tikhonov_solve(torch.from_numpy(Hk),
                                           torch.from_numpy(t), 1e-2,
                                           kdim).numpy(),
            np.asarray(jproj.projected_tikhonov_solve(
                jnp.asarray(Hk), jnp.asarray(t), 1e-2, kdim)), rtol=1e-12)
        np.testing.assert_allclose(
            tproj.projected_ls_solve(torch.from_numpy(Hk),
                                     torch.from_numpy(t), kdim).numpy(),
            np.asarray(jproj.projected_ls_solve(jnp.asarray(Hk),
                                                jnp.asarray(t), kdim)),
            rtol=1e-12)


def test_tikhonov_solve_float32_below_the_grams_rounding():
    """A float32 Hessenberg whose Gram H'H rounds far above lam (||H||^2 =
    1e8, lam = 1e-2, singular values down to 1e-4), as AB-GMRES on CT meets
    it: a float32 Cholesky of H'H + lam I finds a non-positive pivot, the
    port's solve (Gram and Cholesky in float64) gives a finite y within
    rel 1e-5 of the float64 least-squares solution of [H; sqrt(lam) I] y
    ~ [t; 0] (no Gram) on the same float32 H, zero beyond kdim."""
    rng = np.random.default_rng(5)
    maxit, kdim, lam = 30, 24, 1e-2
    U = np.linalg.qr(rng.standard_normal((kdim + 1, kdim + 1)))[0]
    V = np.linalg.qr(rng.standard_normal((kdim, kdim)))[0]
    sv = np.logspace(4, -4, kdim)
    H = np.zeros((maxit + 1, maxit), np.float32)
    H[:kdim + 1, :kdim] = (U[:, :kdim] * sv) @ V.T
    t = np.zeros(maxit + 1, np.float32)
    t[:kdim + 1] = rng.standard_normal(kdim + 1)
    Ht, tt = torch.from_numpy(H), torch.from_numpy(t)
    G32 = Ht[:, :kdim].T @ Ht[:, :kdim] + lam * torch.eye(kdim)
    assert int(torch.linalg.cholesky_ex(G32)[1]) > 0
    y = tproj.projected_tikhonov_solve(Ht, tt, lam, kdim)
    assert y.dtype == torch.float32 and bool(torch.isfinite(y).all())
    assert not y[kdim:].any()
    Hk = H[:, :kdim].astype(np.float64)
    want = np.linalg.lstsq(np.vstack([Hk, np.sqrt(lam) * np.eye(kdim)]),
                           np.concatenate([t, np.zeros(kdim)]),
                           rcond=None)[0]
    err = np.max(np.abs(y[:kdim].numpy() - want)) / np.max(np.abs(want))
    assert err <= 1e-5, err


@pytest.mark.parametrize("lam", [None, 1e-2, 0.37, "gcv", "gcv-final",
                                 [1e-2, 2e-2, 5e-3]])
def test_fingerprint_matches_jax(lam):
    np.testing.assert_array_equal(tfp(None, lam, tag="x0_reg").numpy(),
                                  np.asarray(jfp(None, lam, tag="x0_reg")))


@pytest.mark.parametrize("method", ["ba", "ab"])
@pytest.mark.parametrize("lam", [None, 1e-3, "gcv"])
def test_defer_histories_and_gcv_match_jax(method, lam):
    """Single-RHS ``defer_histories=True`` (and ``lam="gcv"``, in-loop and
    deferred) against the JAX package: histories over K steps, x, niters
    and the final active flag, with a warm start."""
    A, B, b, x_true = _pair(seed=4)
    x0 = 0.3 * x_true
    jsolve = getattr(jgmres, f"{method}_gmres")
    tsolve = getattr(tgmres, f"{method}_gmres")
    for defer in (False, True):
        kw = dict(tol=0.0, maxit=K, lam=lam, residual="fused",
                  defer_histories=defer)
        jr = jsolve(jnp.asarray(A), jnp.asarray(B), jnp.asarray(b),
                    jnp.asarray(x_true), x0=jnp.asarray(x0), **kw)
        tr = tsolve(torch.from_numpy(A), torch.from_numpy(B),
                    torch.from_numpy(b), torch.from_numpy(x_true),
                    x0=torch.from_numpy(x0), **kw)
        _compare(jr, tr)
        np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=1e-8,
                                   atol=1e-10)
        assert bool(tr.active) == bool(jr.active)
        assert tr.IMG.shape == jr.IMG.shape
        np.testing.assert_allclose(tr.IMG.numpy(), np.asarray(jr.IMG),
                                   atol=1e-12)


def test_defer_histories_post_hoc_stop_matches_jax():
    """A tolerance hit inside the budget: the deferred mode reports the
    masked loop's niters, NaN tail, x and inactive flag."""
    A, B, b, x_true = _pair(m=30, n=12, seed=2)
    kw = dict(tol=1e-2, maxit=12, lam=None, residual="fused",
              defer_histories=True)
    jr = jgmres.ba_gmres(jnp.asarray(A), jnp.asarray(B), jnp.asarray(b),
                         jnp.asarray(x_true), **kw)
    tr = tgmres.ba_gmres(torch.from_numpy(A), torch.from_numpy(B),
                         torch.from_numpy(b), torch.from_numpy(x_true), **kw)
    assert 0 < int(jr.niters) < 12
    _compare(jr, tr, k=int(jr.niters))
    assert not bool(tr.active) and not bool(jr.active)
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=1e-9)
    with pytest.raises(ValueError, match="fused"):
        tgmres.ba_gmres(torch.from_numpy(A), torch.from_numpy(B),
                        torch.from_numpy(b), maxit=3, defer_histories=True)
