"""PyTorch port: the RTP solvers, the restarted wrappers and the last
branches of ``gmres_core`` (``history=False``, single-RHS ``resume_from``,
``basis_dtype``) against the JAX package, with ``arnoldi`` and the
full-float32 matmul context.

Float64 on the CPU, the same seeded numpy inputs to both packages.
Histories are compared over the first 8 iterations at rtol 1e-10 and x at
1e-8 (the convention of ``tests/test_torch_solvers.py``): the packages run
the same algorithm with different BLAS summation orders.  The CT n=16
cases run float32 int8 panels (the JAX side through its Pallas kernel in
interpret mode, the port through the plain versions) inside a float64
solve, at 1e-5 of the largest entry as in ``tests/test_torch_slice.py``.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hybrid_gmres_tpu.krylov.arnoldi import arnoldi as jarnoldi
from hybrid_gmres_tpu.solvers import gmres as jgmres
from hybrid_gmres_tpu.solvers import rtp as jrtp
from hybrid_gmres_tpu.utils import checkpoint as jckpt
from hybrid_gmres_tpu_torch.krylov.arnoldi import arnoldi as tarnoldi
from hybrid_gmres_tpu_torch.ops.linear_operator import DenseOperator
from hybrid_gmres_tpu_torch.solvers import gmres as tgmres
from hybrid_gmres_tpu_torch.solvers import rtp as trtp
from hybrid_gmres_tpu_torch.utils import checkpoint as tckpt
from hybrid_gmres_tpu_torch.utils.convert import gmres_result_from_numpy
from hybrid_gmres_tpu_torch.utils.device import full_float32_matmul

RTOL, XTOL = 1e-10, 1e-8
K = 8  # iterations compared


def _pair(m=40, n=24, seed=0):
    """A well-conditioned mismatched pair (B = A^T + 1e-4 E)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) * 0.1 + np.eye(m, n)
    B = A.T + 1e-4 * rng.standard_normal((n, m))
    x_true = rng.standard_normal(n)
    b = A @ x_true + 1e-3 * rng.standard_normal(m)
    return A, B, b, x_true


def _shaw(n=16, seed=0):
    """shaw n with 1% noise and B = A^T + 1e-4 E, from the JAX package's
    generator (the port's is the same numpy code)."""
    from hybrid_gmres_tpu.problems import generate_test_problem

    A, b_exact, x_true = (np.asarray(a) for a in
                          generate_test_problem("shaw", n))
    rng = np.random.default_rng(seed)
    e = rng.standard_normal(n)
    b = b_exact + 1e-2 * np.linalg.norm(b_exact) * e / np.linalg.norm(e)
    B = A.T + 1e-4 * rng.standard_normal((n, n))
    return A, B, b, x_true


def _both(arrays):
    """The same numpy arrays for both packages."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.array(a)) for a in arrays])


def _compare(jr, tr, k=K, rtol=RTOL, xtol=XTOL):
    for name in ("res_hist", "err_hist"):
        want = np.asarray(getattr(jr, name))
        got = getattr(tr, name).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got[:k], want[:k], rtol=rtol,
                                   err_msg=name)
    assert int(tr.niters) == int(jr.niters)
    want = np.asarray(jr.x)
    np.testing.assert_allclose(tr.x.numpy(), want, rtol=xtol,
                               atol=xtol * np.abs(want).max())


def _solver(pkg, method, rtp=False):
    mod = {("j", False): jgmres, ("t", False): tgmres,
           ("j", True): jrtp, ("t", True): trtp}[pkg, rtp]
    return getattr(mod, f"{method}_gmres" + ("_rtp" if rtp else ""))


@pytest.mark.parametrize("method", ["ba", "ab"])
@pytest.mark.parametrize("lam", [1e-3, 1e-2])
def test_rtp_matches_jax_on_shaw(method, lam):
    """RTP on shaw n=16 (ill-posed; the shift makes the Krylov operator
    well-conditioned): histories, x, H, niters."""
    (jA, jB, jb, jx), (tA, tB, tb, tx) = _both(_shaw())
    kw = dict(tol=0.0, maxit=12, lam=lam)
    jr = _solver("j", method, True)(jA, jB, jb, jx, **kw)
    tr = _solver("t", method, True)(tA, tB, tb, tx, **kw)
    _compare(jr, tr)
    np.testing.assert_allclose(tr.H.numpy()[:K + 1, :K],
                               np.asarray(jr.H)[:K + 1, :K], rtol=RTOL,
                               atol=1e-13)
    assert tr.IMG is None and tr.fp is None


def _ct16():
    from hybrid_gmres_tpu.problems import ct as jct
    from hybrid_gmres_tpu_torch.problems import ct as tct

    jp = jct.ct_mismatched(n=16, n_angles=24, n_det=24, dense=False)
    jA, jB, jb, jx, _, _ = jct.ct_tpu_operators(jp, dtype=jnp.int8)
    jA.interpret = jB.interpret = True
    tp = tct.ct_mismatched(n=16, n_angles=24, n_det=24)
    tA, tB, tb, tx, _, _ = tct.ct_gpu_operators(tp, dtype="int8",
                                                device="cpu")
    return (jA, jB, jb, jx), (tA, tB, tb, tx)


@pytest.mark.parametrize("method", ["ba", "ab"])
def test_rtp_ct16_int8_matches_jax(method):
    """The slice's operators: CT n=16 int8 panels (float32 products in a
    float64 solve), 8 steps.  AB-RTP's per-step ``A Q`` is the JAX
    package's vmapped interpret-mode K1 against the port's plain K2."""
    (jA, jB, jb, jx), (tA, tB, tb, tx) = _ct16()
    kw = dict(tol=0.0, maxit=8, lam=1e-2)
    jr = _solver("j", method, True)(jA, jB, jb, jx, **kw)
    tr = _solver("t", method, True)(tA, tB, tb, tx, **kw)
    assert int(tr.niters) == int(jr.niters) == 8
    for name in ("res_hist", "err_hist", "x"):
        want = np.asarray(getattr(jr, name))
        got = getattr(tr, name).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("method", ["ba", "ab"])
@pytest.mark.parametrize("rtp", [False, True])
@pytest.mark.parametrize("lam", [None, 1e-3])
def test_history_false_matches_jax(method, rtp, lam):
    """``history=False``: one Arnoldi, one projected solve, one residual and
    error in slot ``nsteps-1`` of NaN histories (RTP too: its lam is the
    shift, so None becomes 1e-3)."""
    (jA, jB, jb, jx), (tA, tB, tb, tx) = _both(_pair(seed=5))
    kw = dict(tol=0.0, maxit=K, lam=1e-3 if rtp and lam is None else lam,
              history=False)
    jr = _solver("j", method, rtp)(jA, jB, jb, jx, **kw)
    tr = _solver("t", method, rtp)(tA, tB, tb, tx, **kw)
    _compare(jr, tr)
    assert np.isfinite(tr.res_hist.numpy()).sum() == 1
    np.testing.assert_allclose(tr.H.numpy(), np.asarray(jr.H), rtol=RTOL,
                               atol=1e-13)
    np.testing.assert_allclose(tr.Q.numpy(), np.asarray(jr.Q), rtol=RTOL,
                               atol=1e-13)
    # the final x of the history run, to the band of a longer recurrence
    full = _solver("t", method, rtp)(tA, tB, tb, tx,
                                     **{**kw, "history": True})
    np.testing.assert_allclose(tr.x.numpy(), full.x.numpy(), rtol=1e-9,
                               atol=1e-12)


@pytest.mark.parametrize("method", ["ba", "ab"])
@pytest.mark.parametrize("residual", ["true", "fused"])
def test_restarted_matches_jax(method, residual):
    """Restarted GMRES(4) x 3 cycles: the joined histories, niters, x."""
    (jA, jB, jb, jx), (tA, tB, tb, tx) = _both(_pair(seed=6))
    kw = dict(tol=1e-12, restart=4, max_restarts=3, lam=1e-3,
              residual=residual)
    jr = getattr(jgmres, f"{method}_gmres_restarted")(jA, jB, jb, jx, **kw)
    tr = getattr(tgmres, f"{method}_gmres_restarted")(tA, tB, tb, tx, **kw)
    assert int(tr.niters) == int(jr.niters) == 12
    assert tr.res_hist.shape == (12,)
    _compare(jr, tr, k=12)
    # the aggregate holds the last cycle's factorization only
    with pytest.raises(ValueError, match="restarted"):
        getattr(tgmres, f"{method}_gmres")(tA, tB, tb, tx, maxit=8,
                                           lam=1e-3, resume_from=tr)


@pytest.mark.parametrize("method", ["ba", "ab"])
@pytest.mark.parametrize("residual", ["true", "fused"])
@pytest.mark.parametrize("x0", [False, True])
def test_resume_equals_uninterrupted_and_jax(method, residual, x0):
    """resume(run(maxit=4), maxit=K) continues run(maxit=K) bit for bit in
    the port: the factorization, the images, x and every history entry from
    the resumed step on.  The first 4 entries are the partial run's, whose
    projected problems are padded to 4 and not K: the CPU's BLAS may sum
    them in another order (the JAX package's own test holds its resume to
    rtol 1e-6 for that reason).  Against the JAX package's resume: the usual
    band."""
    A, B, b, xt = _pair(seed=7)
    (jA, jB, jb, jx), (tA, tB, tb, tx) = _both((A, B, b, xt))
    jx0 = jnp.asarray(0.3 * xt) if x0 else None
    tx0 = torch.from_numpy(0.3 * xt) if x0 else None
    kw = dict(tol=0.0, lam=1e-3, residual=residual)
    tsolve, jsolve = _solver("t", method), _solver("j", method)
    full = tsolve(tA, tB, tb, tx, maxit=K, x0=tx0, **kw)
    part = tsolve(tA, tB, tb, tx, maxit=4, x0=tx0, **kw)
    resumed = tsolve(tA, tB, tb, tx, maxit=K, x0=tx0, resume_from=part, **kw)
    for name in ("x", "H", "Q", "niters", "active", "IMG", "S"):
        a, b = getattr(resumed, name), getattr(full, name)
        assert (a is None and b is None) or torch.equal(a, b), name
    for name in ("res_hist", "err_hist"):
        a, b = getattr(resumed, name), getattr(full, name)
        assert torch.equal(a[4:], b[4:]), name
        np.testing.assert_allclose(a[:4].numpy(), b[:4].numpy(), rtol=1e-12)
    jpart = jsolve(jA, jB, jb, jx, maxit=4, x0=jx0, **kw)
    jres = jsolve(jA, jB, jb, jx, maxit=K, x0=jx0, resume_from=jpart, **kw)
    _compare(jres, resumed)


@pytest.mark.parametrize("method", ["ba", "ab"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_crosses_packages(method, direction, tmp_path):
    """A fused checkpoint written by one package's ``save_state`` resumes in
    the other's solver and lands on the other's uninterrupted run."""
    (jA, jB, jb, jx), (tA, tB, tb, tx) = _both(_pair(seed=8))
    kw = dict(tol=0.0, lam=1e-2, residual="fused")
    tsolve, jsolve = _solver("t", method), _solver("j", method)
    path = str(tmp_path / "state.npz")
    if direction == "jax_to_port":
        jckpt.save_state(path, jsolve(jA, jB, jb, jx, maxit=4, **kw))
        state = tckpt.load_state(path, device="cpu")
        got = tsolve(tA, tB, tb, tx, maxit=K, resume_from=state, **kw)
        want = jsolve(jA, jB, jb, jx, maxit=K, **kw)
        _compare(want, got)
    else:
        tckpt.save_state(path, tsolve(tA, tB, tb, tx, maxit=4, **kw))
        got = jsolve(jA, jB, jb, jx, maxit=K, resume_from=jckpt.load_state(
            path), **kw)
        want = tsolve(tA, tB, tb, tx, maxit=K, **kw)
        _compare(got, want)


def test_resume_of_a_stopped_run_stays_stopped():
    """A run that stopped on tol resumes inactive (the checkpointed flag),
    and a legacy checkpoint without the flag falls back on niters == budget,
    as in the JAX package."""
    (jA, jB, jb, jx), (tA, tB, tb, tx) = _both(_pair(m=30, n=12, seed=2))
    kw = dict(tol=1e-2, lam=None, residual="true")
    part = tgmres.ba_gmres(tA, tB, tb, tx, maxit=12, **kw)
    assert 0 < int(part.niters) < 12 and not bool(part.active)
    more = tgmres.ba_gmres(tA, tB, tb, tx, maxit=16, resume_from=part, **kw)
    assert int(more.niters) == int(part.niters)
    assert torch.equal(more.x, part.x)
    jpart = gmres_result_from_numpy(
        jgmres.ba_gmres(jA, jB, jb, jx, maxit=4, **{**kw, "tol": 0.0}),
        device="cpu")._replace(active=None)
    legacy = tgmres.ba_gmres(tA, tB, tb, tx, maxit=8, resume_from=jpart,
                             **{**kw, "tol": 0.0})
    _compare(jgmres.ba_gmres(jA, jB, jb, jx, maxit=8, **{**kw, "tol": 0.0}),
             legacy)


@pytest.mark.parametrize("method", ["ba", "ab"])
@pytest.mark.parametrize("defer", [False, True])
def test_basis_dtype_bf16_matches_jax(method, defer):
    """``basis_dtype=bfloat16``: Q, IMG (and S for AB) stored in bf16, the
    arithmetic in float64 with the stored columns upcast where read; the
    same rounded values as the JAX package's mixed-dtype products."""
    (jA, jB, jb, jx), (tA, tB, tb, tx) = _both(_pair(seed=9))
    kw = dict(tol=0.0, maxit=K, lam=1e-2, residual="fused",
              defer_histories=defer)
    jr = _solver("j", method)(jA, jB, jb, jx, basis_dtype=jnp.bfloat16, **kw)
    tr = _solver("t", method)(tA, tB, tb, tx, basis_dtype=torch.bfloat16,
                              **kw)
    assert tr.Q.dtype == tr.IMG.dtype == torch.bfloat16
    assert tr.x.dtype == tr.H.dtype == torch.float64
    if method == "ab":
        assert tr.S.dtype == torch.bfloat16
    _compare(jr, tr)
    np.testing.assert_array_equal(
        tr.Q.float().numpy(), np.asarray(jr.Q.astype(jnp.float32)))
    # within the bf16 storage band of the full-precision run (the band of
    # the JAX package's tests/test_gmres_api.py:275)
    f64 = _solver("t", method)(tA, tB, tb, tx, **kw)
    np.testing.assert_allclose(tr.res_hist.numpy(), f64.res_hist.numpy(),
                               rtol=5e-3, atol=5e-3)


@functools.lru_cache(maxsize=None)
def _prior(pkg, method, residual):
    """A 3-step result to resume from (one per package, method and mode,
    shared by the cases below)."""
    arrays = _both(_pair(seed=10))[0 if pkg == "j" else 1]
    return _solver(pkg, method)(*arrays, tol=0.0, maxit=3, lam=1e-3,
                                residual=residual)


def _illegal(pkg, kind):
    """(solver, arrays, keywords) of one illegal option combination."""
    bf16 = jnp.bfloat16 if pkg == "j" else torch.bfloat16
    arrays = _both(_pair(seed=10))[0 if pkg == "j" else 1]
    method = "ab" if kind == "ab_fused_resume_no_S" else "ba"

    def prior(residual="true"):
        return _prior(pkg, method, residual)

    kw = {
        "residual": lambda: dict(residual="bogus"),
        "basis_dtype_true": lambda: dict(basis_dtype=bf16),
        "basis_dtype_estimate": lambda: dict(basis_dtype=bf16,
                                             residual="estimate"),
        "defer_true": lambda: dict(defer_histories=True),
        "defer_no_history": lambda: dict(defer_histories=True,
                                         residual="fused", history=False),
        "defer_resume": lambda: dict(defer_histories=True, residual="fused",
                                     resume_from=prior("fused")),
        "fused_no_history": lambda: dict(residual="fused", history=False),
        "fused_resume_no_IMG": lambda: dict(residual="fused", maxit=5,
                                            resume_from=prior()),
        "ab_fused_resume_no_S": lambda: dict(
            residual="fused", maxit=5,
            resume_from=prior("fused")._replace(S=None)),
        "no_history_resume": lambda: dict(history=False, maxit=5,
                                          resume_from=prior()),
        "resume_other_lam": lambda: dict(maxit=5, lam=2e-3,
                                         resume_from=prior()),
        "resume_shrinks": lambda: dict(maxit=2, resume_from=prior()),
    }[kind]()
    return _solver(pkg, method), arrays, {
        **dict(tol=0.0, maxit=3, lam=1e-3), **kw}


@pytest.mark.parametrize("kind", [
    "residual", "basis_dtype_true", "basis_dtype_estimate", "defer_true",
    "defer_no_history", "defer_resume", "fused_no_history",
    "fused_resume_no_IMG", "ab_fused_resume_no_S", "no_history_resume",
    "resume_other_lam", "resume_shrinks"])
def test_illegal_combinations_raise_like_jax(kind):
    """Every option combination the JAX package rejects with ValueError is
    rejected the same way by the port."""
    for pkg in ("j", "t"):
        solve, arrays, kw = _illegal(pkg, kind)
        with pytest.raises(ValueError):
            solve(*arrays, **kw)


@pytest.mark.parametrize("case", ["full", "breakdown"])
def test_arnoldi_matches_jax(case):
    """The plain Arnoldi: Q, H, beta and nsteps.  On a breakdown (M = P, a
    projection of rank 3) the breakdown column of H is recorded and nsteps
    counts only the completed expansions (the JAX rule, which differs from
    gmres_core's adopt-then-stop)."""
    rng = np.random.default_rng(11)
    n, maxit = 12, 6
    if case == "full":
        M = rng.standard_normal((n, n)) + 3 * np.eye(n)
    else:
        V = np.linalg.qr(rng.standard_normal((n, 3)))[0]
        M = V @ np.diag([1.0, 2.0, 3.0]) @ V.T
    r0 = rng.standard_normal(n)
    jQ, jH, jbeta, jn = jarnoldi(lambda q: jnp.asarray(M) @ q,
                                 jnp.asarray(r0), maxit, breakdown_tol=1e-10)
    Mt = torch.from_numpy(M)
    tQ, tH, tbeta, tn = tarnoldi(lambda q: Mt @ q, torch.from_numpy(r0),
                                 maxit, breakdown_tol=1e-10)
    assert int(tn) == int(jn) == (maxit if case == "full" else 3)
    assert tQ.stride(0) == 1                  # column-major basis
    np.testing.assert_allclose(tQ.numpy(), np.asarray(jQ), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(tH.numpy(), np.asarray(jH), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(float(tbeta), float(jbeta), rtol=1e-14)
    if case == "breakdown":
        assert abs(float(tH[4, 3])) <= 1e-10          # recorded breakdown
        assert tH[:, 3].any() and not tQ[:, 4:].any()


SETTINGS = {
    "default": lambda: None,
    "allow_tf32": lambda: setattr(torch.backends.cuda.matmul, "allow_tf32",
                                  True),
    "high": lambda: torch.set_float32_matmul_precision("high"),
    "medium": lambda: torch.set_float32_matmul_precision("medium"),
    "fp32_precision": lambda: setattr(torch.backends.cuda.matmul,
                                      "fp32_precision", "tf32"),
}


def _precision_state():
    """Every getter of the matmul precision (a getter may refuse to read a
    state mixed from the legacy and the per-backend settings)."""
    out = []
    for get in (torch.get_float32_matmul_precision,
                lambda: torch.backends.cuda.matmul.allow_tf32,
                lambda: torch.backends.cuda.matmul.fp32_precision,
                lambda: torch.backends.mkldnn.matmul.fp32_precision):
        try:
            out.append(get())
        except RuntimeError:
            out.append("refused")
    return out


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_full_float32_matmul_restores_the_callers_setting(setting):
    """Inside the context float32 matmuls run in full float32 (no TF32, no
    bf16); whatever the caller set comes back afterwards, getter for getter,
    even after an exception."""
    backends = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)
    saved = [b.fp32_precision for b in backends]
    try:
        SETTINGS[setting]()
        want = _precision_state()
        with pytest.raises(KeyError):
            with full_float32_matmul():
                assert [b.fp32_precision for b in backends] == ["ieee"] * 2
                raise KeyError
        assert _precision_state() == want
    finally:
        for b, val in zip(backends, saved):
            b.fp32_precision = val


def test_ab_rtp_hands_the_product_a_column_major_basis():
    """AB-RTP's per-step ``A.matmat`` gets the masked basis as the
    transposed view of a (maxit, n) tensor (what the card's K2 reads
    without an interleaving copy), and the columns past k as zeros."""
    A, B, b, xt = _pair(seed=12)
    seen = []

    class Recording(DenseOperator):
        def matmat(self, X):
            seen.append((X.stride(), int((X.abs().sum(0) > 0).sum())))
            return super().matmat(X)

    trtp.ab_gmres_rtp(Recording(torch.from_numpy(A)), torch.from_numpy(B),
                      torch.from_numpy(b), tol=0.0, maxit=5, lam=1e-2)
    n = A.shape[1]
    assert [s for s, _ in seen] == [(1, n)] * 5
    assert [c for _, c in seen] == [1, 2, 3, 4, 5]
