"""PyTorch port: the batched (multi-RHS) GMRES solvers, checkpoint/resume and
the noise helpers against the JAX package.

Float64 on the CPU, the same seeded numpy inputs to both packages.  Unless a
test says otherwise, histories, x and H are compared at rtol 1e-9 over K = 8
iterations of a well-conditioned pair: the two packages run the same
recurrences with different BLAS summation orders.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hybrid_gmres_tpu.problems import noise as jnoise
from hybrid_gmres_tpu.solvers import batched as jbatched
from hybrid_gmres_tpu.utils import checkpoint as jckpt
from hybrid_gmres_tpu_torch.problems import noise as tnoise
from hybrid_gmres_tpu_torch.solvers import batched as tbatched
from hybrid_gmres_tpu_torch.solvers.gmres import ba_gmres as tba
from hybrid_gmres_tpu_torch.utils import checkpoint as tckpt
from hybrid_gmres_tpu_torch.utils.convert import gmres_result_from_numpy

RTOL = 1e-9
K = 8


def _pair(m=40, n=24, R=4, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) * 0.1 + np.eye(m, n)
    B = A.T + 1e-4 * rng.standard_normal((n, m))
    Xt = rng.standard_normal((n, R))
    b = A @ Xt + 1e-3 * rng.standard_normal((m, R))
    X0 = Xt + 0.2 * rng.standard_normal((n, R))
    return A, B, b, Xt, X0


def _port(kind, arrays, x0=None, **kw):
    A, B, b, Xt = arrays
    return getattr(tbatched, f"{kind}_gmres_batched")(
        torch.from_numpy(A), torch.from_numpy(B), torch.from_numpy(b),
        torch.from_numpy(Xt), x0=None if x0 is None else torch.from_numpy(x0),
        **kw)


def _solve(kind, arrays, x0=None, **kw):
    """The same call through both packages."""
    A, B, b, Xt = arrays
    jr = getattr(jbatched, f"{kind}_gmres_batched")(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(b), jnp.asarray(Xt),
        x0=None if x0 is None else jnp.asarray(x0), **kw)
    return jr, _port(kind, arrays, x0, **kw)


def _compare(jr, tr, rtol=RTOL, bases=True):
    for name in ("x", "err_hist", "res_hist", "niters", "Q", "H", "beta",
                 "IMG", "S", "active"):
        jv, tv = getattr(jr, name), getattr(tr, name)
        assert (jv is None) == (tv is None), name
        if jv is None:
            continue
        jv = np.asarray(jv)
        assert tuple(tv.shape) == jv.shape, name
        if name in ("niters", "active"):
            np.testing.assert_array_equal(tv.numpy(), jv, err_msg=name)
        elif bases or name not in ("Q", "H", "IMG", "S"):
            np.testing.assert_allclose(
                tv.numpy(), jv, rtol=rtol, equal_nan=True, err_msg=name,
                atol=rtol * max(np.nanmax(np.abs(jv)), 1e-300))
    np.testing.assert_allclose(tr.fp.numpy(), np.asarray(jr.fp), rtol=1e-5)


@pytest.mark.parametrize("kind", ["ba", "ab"])
@pytest.mark.parametrize("lam", [None, 1e-3, "gcv"])
def test_batched_matches_jax(kind, lam):
    A, B, b, Xt, _ = _pair()
    jr, tr = _solve(kind, (A, B, b, Xt), tol=0.0, maxit=K, lam=lam)
    assert tr.x.shape == (24, 4) and tr.res_hist.shape == (K, 4)
    assert tr.H.shape == (K + 1, K, 4) and tr.IMG.shape == (40, K, 4)
    assert tr.Q.shape == ((24 if kind == "ba" else 40), K + 1, 4)
    _compare(jr, tr)


@pytest.mark.parametrize("kind", ["ba", "ab"])
def test_batched_matches_its_single_rhs_solver(kind):
    """Per RHS the numbers are those of the port's single-RHS solver with
    ``residual="fused"`` (not block GMRES)."""
    from hybrid_gmres_tpu_torch.solvers import gmres as tgmres

    A, B, b, Xt, X0 = (torch.from_numpy(a) for a in _pair(seed=1))
    r = getattr(tbatched, f"{kind}_gmres_batched")(
        A, B, b, Xt, maxit=K, lam=1e-3, x0=X0)
    for j in range(b.shape[1]):
        rj = getattr(tgmres, f"{kind}_gmres")(
            A, B, b[:, j], Xt[:, j], tol=0.0, maxit=K, lam=1e-3, x0=X0[:, j],
            residual="fused")
        for name in ("res_hist", "err_hist", "x"):
            np.testing.assert_allclose(getattr(r, name)[..., j].numpy(),
                                       getattr(rj, name).numpy(), rtol=RTOL)
        np.testing.assert_allclose(r.Q[:, :, j].numpy(), rj.Q.numpy(),
                                   atol=1e-12)


@pytest.mark.parametrize("kind", ["ba", "ab"])
def test_batched_warm_start_and_chunking_match_jax(kind):
    """R=5 in scans of 2 (the last one narrower), (n, R) warm start; and a
    (n,) warm start and truth broadcast over the batch."""
    A, B, b, Xt, X0 = _pair(R=5, seed=2)
    jr, tr = _solve(kind, (A, B, b, Xt), x0=X0, maxit=K, lam=1e-3,
                    chunk_rhs=2)
    _compare(jr, tr)
    jr, tr = _solve(kind, (A, B, b, Xt[:, 0]), x0=X0[:, 0], maxit=K,
                    lam=1e-3, chunk_rhs=None)
    _compare(jr, tr)


def test_batched_per_rhs_early_exit_matches_jax():
    """tol stops each RHS on its own iteration: niters, the NaN tails, the
    frozen x and the final active flags match."""
    A, B, b, Xt, _ = _pair(m=30, n=12, seed=3)
    b = b + np.linspace(0, 3e-2, 4) * np.random.default_rng(9) \
        .standard_normal(b.shape)          # a different noise level per RHS
    jr, tr = _solve("ba", (A, B, b, Xt), tol=2e-2, maxit=12, lam=None)
    niters = np.asarray(jr.niters)
    assert len(set(niters.tolist())) > 1 and niters.min() < 12
    _compare(jr, tr, bases=False)
    # frozen RHS keep their Q/H columns: zero beyond their stop
    for j, k in enumerate(niters):
        assert not tr.Q[:, k + 1:, j].any() or k == 12


@pytest.mark.parametrize("kind", ["ba", "ab"])
def test_batched_defer_histories_matches_jax(kind):
    A, B, b, Xt, X0 = _pair(seed=11)
    kw = dict(maxit=K, lam=1e-3, chunk_rhs=2, defer_histories=True)
    jr, tr = _solve(kind, (A, B, b, Xt), x0=X0, **kw)
    _compare(jr, tr)
    # ... and the port's in-scan mode gives the same numbers
    ts = _port(kind, (A, B, b, Xt), x0=X0, maxit=K, lam=1e-3, chunk_rhs=2)
    for name in ("res_hist", "err_hist", "x", "IMG"):
        np.testing.assert_allclose(getattr(tr, name).numpy(),
                                   getattr(ts, name).numpy(), rtol=1e-9,
                                   atol=1e-12)
    # post-hoc tol stopping, at a tolerance that the columns reach at
    # different steps inside the budget
    tol = 1.5 * float(ts.res_hist[4].max())
    jr, tr = _solve(kind, (A, B, b, Xt), x0=X0, tol=tol, **kw)
    assert np.asarray(jr.niters).max() <= 5
    _compare(jr, tr, bases=False)
    tt = _port(kind, (A, B, b, Xt), x0=X0, maxit=K, lam=1e-3, chunk_rhs=2,
               tol=tol)
    np.testing.assert_array_equal(tt.niters.numpy(), tr.niters.numpy())
    np.testing.assert_array_equal(tt.active.numpy(), tr.active.numpy())
    np.testing.assert_allclose(tt.x.numpy(), tr.x.numpy(), rtol=1e-9)


def test_batched_defer_edge_cases_match_jax():
    """An exactly converged warm start returns x0 (not zero), and a
    breakdown on the FINAL iteration ends inactive, in both packages
    (float32, as the JAX package's own test)."""
    rng = np.random.default_rng(0)
    A = (rng.standard_normal((16, 8)) * 0.1 + np.eye(16, 8)).astype(
        np.float32)
    B = A.T.copy()
    X0 = rng.standard_normal((8, 2)).astype(np.float32)
    bb = A @ X0
    jr = jbatched.ba_gmres_batched(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(bb), maxit=4, lam=1e-3,
        x0=jnp.asarray(X0), defer_histories=True)
    tr = tbatched.ba_gmres_batched(
        torch.from_numpy(A), torch.from_numpy(B), torch.from_numpy(bb),
        maxit=4, lam=1e-3, x0=torch.from_numpy(X0), defer_histories=True)
    np.testing.assert_allclose(tr.x.numpy(), X0, atol=1e-6)
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), atol=1e-6)
    assert torch.isnan(tr.err_hist).all()       # no x_true given

    I8 = np.eye(8, dtype=np.float32)
    be = np.zeros((8, 2), np.float32)
    be[0, 0], be[1, 1] = 1.0, 2.0
    jr = jbatched.ba_gmres_batched(
        jnp.asarray(I8), jnp.asarray(I8), jnp.asarray(be), maxit=1, lam=1e-1,
        defer_histories=True)
    for defer in (False, True):
        tr = tbatched.ba_gmres_batched(
            torch.from_numpy(I8), torch.from_numpy(I8), torch.from_numpy(be),
            maxit=1, lam=1e-1, defer_histories=defer)
        assert not tr.active.any() and not np.asarray(jr.active).any()
        np.testing.assert_array_equal(tr.niters.numpy(),
                                      np.asarray(jr.niters))
        np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=1e-6)


def test_batched_gcv_final_matches_jax():
    """``lam="gcv-final"``: one lambda per RHS from the final projected
    problem, the same one in both packages (so the histories agree); it
    needs ``defer_histories=True``."""
    A, B, b, Xt, _ = _pair(seed=5)
    b = b + 0.05 * np.random.default_rng(1).standard_normal(b.shape)
    grid = np.logspace(-6, 0, 30)
    jr, tr = _solve("ba", (A, B, b, Xt), maxit=K, lam="gcv-final",
                    gcv_grid=grid, defer_histories=True)
    _compare(jr, tr)
    with pytest.raises(ValueError, match="gcv-final"):
        tbatched.ba_gmres_batched(torch.from_numpy(A), torch.from_numpy(B),
                                  torch.from_numpy(b), maxit=K,
                                  lam="gcv-final")


@pytest.mark.parametrize("kind", ["ba", "ab"])
def test_batched_resume_of_a_jax_state_matches_jax(kind, tmp_path):
    """The JAX package runs ``maxit=k``; the port resumes that state to
    ``K`` — carried across as arrays and through a saved ``.npz`` — and
    equals the JAX package's uninterrupted run.  The port's own file loads
    in the JAX package."""
    A, B, b, Xt, X0 = _pair(R=5, seed=6)
    kw = dict(lam=1e-3, chunk_rhs=2)
    jpart, _ = _solve(kind, (A, B, b, Xt), x0=X0, maxit=3, **kw)
    jfull, tfull = _solve(kind, (A, B, b, Xt), x0=X0, maxit=K, **kw)
    _compare(jfull, tfull)

    carried = gmres_result_from_numpy(jpart, device="cpu")
    path = str(tmp_path / "state.npz")
    jckpt.save_state(path, jpart)
    loaded = tckpt.load_state(path, device="cpu")
    for state in (carried, loaded):
        assert state.niters.dtype == torch.int32
        assert state.active.dtype == torch.bool
        solver = getattr(tbatched, f"{kind}_gmres_batched")
        tr = solver(torch.from_numpy(A), torch.from_numpy(B),
                    torch.from_numpy(b), torch.from_numpy(Xt),
                    x0=torch.from_numpy(X0), maxit=K, resume_from=state, **kw)
        _compare(jfull, tr)
        # the resumed loop wrote into its own arrays, not the checkpoint's
        np.testing.assert_array_equal(state.Q.numpy(), np.asarray(jpart.Q))

    tpath = str(tmp_path / "port.npz")
    tckpt.save_state(tpath, tfull)
    back = jckpt.load_state(tpath)
    _compare(back, tfull, rtol=0)


def test_batched_error_cases():
    A, B, b, Xt, X0 = (torch.from_numpy(a) for a in _pair(seed=7))
    with pytest.raises(ValueError, match="shape"):
        tbatched.ba_gmres_batched(A, B, b[:, 0], Xt, maxit=4)
    part = tbatched.ba_gmres_batched(A, B, b, Xt, maxit=3, lam=1e-3, x0=X0)
    with pytest.raises(ValueError, match="defer_histories"):
        tbatched.ba_gmres_batched(A, B, b, Xt, maxit=6, lam=1e-3, x0=X0,
                                  defer_histories=True, resume_from=part)
    with pytest.raises(ValueError, match="fingerprint"):
        tbatched.ba_gmres_batched(A, B, b, Xt, maxit=6, lam=2e-3, x0=X0,
                                  resume_from=part)
    with pytest.raises(ValueError, match="fingerprint"):
        tbatched.ba_gmres_batched(A, B, b, Xt, maxit=6, lam=1e-3,
                                  resume_from=part)
    with pytest.raises(ValueError, match="IMG"):
        tbatched.ba_gmres_batched(A, B, b, Xt, maxit=6, lam=1e-3, x0=X0,
                                  resume_from=part._replace(IMG=None))
    with pytest.raises(ValueError, match="IMG/.S"):
        tbatched.ab_gmres_batched(A, B, b, Xt, maxit=6, lam=1e-3, x0=X0,
                                  resume_from=part)
    with pytest.raises(ValueError, match="maxit >="):
        tbatched.ba_gmres_batched(A, B, b, Xt, maxit=2, lam=1e-3, x0=X0,
                                  resume_from=part)
    with pytest.raises(ValueError, match="active"):
        tbatched.ba_gmres_batched(A, B, b, Xt, maxit=6, lam=1e-3, x0=X0,
                                  resume_from=part._replace(active=None))
    with pytest.raises(ValueError, match="chunk_rhs"):
        tbatched.ba_gmres_batched(A, B, b, Xt, maxit=3, chunk_rhs=0)
    # a legacy (2,) fingerprint of the same solve is accepted
    ok = tbatched.ba_gmres_batched(
        A, B, b, Xt, maxit=4, lam=1e-3, x0=X0,
        resume_from=part._replace(fp=part.fp[:2]))
    assert ok.res_hist.shape == (4, 4)


def test_single_rhs_checkpoint_helpers_match_jax(tmp_path):
    """save/load round trip of a single-RHS result, ``pad_state`` and
    ``check_resumable`` against the JAX functions; a legacy file without
    the active flag warns in the ambiguous case."""
    from hybrid_gmres_tpu.solvers.gmres import ba_gmres as jba

    A, B, b, Xt, _ = _pair(seed=8)
    kw = dict(tol=0.0, maxit=4, lam=1e-3, residual="fused")
    jr = jba(jnp.asarray(A), jnp.asarray(B), jnp.asarray(b[:, 0]),
             jnp.asarray(Xt[:, 0]), **kw)
    tr = tba(torch.from_numpy(A), torch.from_numpy(B),
             torch.from_numpy(b[:, 0]), torch.from_numpy(Xt[:, 0]), **kw)
    path = str(tmp_path / "single.npz")
    tckpt.save_state(path, tr)
    _compare(jckpt.load_state(path), tr, rtol=0)
    jp, tp = jckpt.pad_state(jr, 7), tckpt.pad_state(tr, 7)
    _compare(jp, tp)
    assert tckpt.pad_state(tr, 4) is tr
    with pytest.raises(ValueError, match="shrink"):
        tckpt.pad_state(tr, 3)
    tckpt.check_resumable(tr)
    with pytest.raises(ValueError, match="restarted"):
        tckpt.check_resumable(tr._replace(niters=torch.tensor(9)))
    tckpt.check_fingerprint(tr, None, 1e-3)
    tckpt.check_fingerprint(tr._replace(fp=None), None, 5.0)
    with pytest.raises(ValueError, match="fingerprint"):
        tckpt.check_fingerprint(tr, None, "gcv")
    legacy = str(tmp_path / "legacy.npz")
    with np.load(path) as z:
        np.savez(legacy, **{k: z[k] for k in z.files if k != "active"})
    with pytest.warns(UserWarning, match="legacy checkpoint"):
        assert tckpt.load_state(legacy, device="cpu").active is None


def test_noise_helpers_match_jax():
    rng = np.random.default_rng(0)
    b = rng.standard_normal(50)
    A = rng.standard_normal((6, 4)).astype(np.float32)
    jb, je = jnoise.add_noise(jnp.asarray(b), 0.25, seed=3)
    tb, te = tnoise.add_noise(torch.from_numpy(b), 0.25, seed=3)
    nb, _ = tnoise.add_noise(b, 0.25, seed=3)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(nb, np.asarray(jb))
    assert abs(float(te.norm() / torch.from_numpy(b).norm()) - 0.25) < 1e-12
    for normalize in (False, True):
        jB, jE = jnoise.perturb_backprojector(jnp.asarray(A), 1e-2, seed=1,
                                              normalize=normalize)
        tB, tE = tnoise.perturb_backprojector(torch.from_numpy(A), 1e-2,
                                              seed=1, normalize=normalize)
        assert tB.dtype == torch.float32 and tB.shape == (4, 6)
        np.testing.assert_array_equal(tB.numpy(), np.asarray(jB))
        np.testing.assert_array_equal(tE.numpy(), np.asarray(jE))
