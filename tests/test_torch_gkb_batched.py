"""PyTorch port: the batched GKB solvers (``lsqr_batched``,
``hybrid_lsqr_batched``, ``lsmr_batched``) against the JAX package, against
the port's single-RHS solvers, and across a checkpoint.

Float64 on dense operators where the algorithm is the point; float32 through
the int8 block-ELL operators with forward panels only (the JAX side runs its
multi-RHS transposed Pallas kernel in interpret mode, the port K4's plain
version) for the slice as a whole.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hybrid_gmres_tpu.problems import onedim as jonedim
from hybrid_gmres_tpu.utils import checkpoint as jckpt
from hybrid_gmres_tpu_torch.utils import checkpoint as tckpt
from hybrid_gmres_tpu_torch.utils.convert import gkb_state_from_numpy

jgkb = importlib.import_module("hybrid_gmres_tpu.solvers.gkb_batched")
tgkb = importlib.import_module("hybrid_gmres_tpu_torch.solvers.gkb_batched")
tlsqr = importlib.import_module("hybrid_gmres_tpu_torch.solvers.lsqr")
tlsmr = importlib.import_module("hybrid_gmres_tpu_torch.solvers.lsmr")

SOLVERS = {
    "lsqr_batched": (jgkb.lsqr_batched, tgkb.lsqr_batched, tlsqr.lsqr, {}),
    "hybrid_lsqr_batched": (jgkb.hybrid_lsqr_batched,
                            tgkb.hybrid_lsqr_batched, tlsqr.hybrid_lsqr,
                            {"lam": 1e-3}),
    "lsmr_batched": (jgkb.lsmr_batched, tgkb.lsmr_batched, tlsmr.lsmr, {}),
}
NAMES = list(SOLVERS)
FIELDS = ("x", "res_hist", "err_hist", "ar_hist", "niters")
R = 3
# As in test_torch_gkb.py: with ``reorth`` float64 differences between the
# packages stay near 1e-15 over 12 steps (heat, n=40); the short recurrences
# alone amplify them (3e-12 after 6 steps), so those run 6 steps.
RTOL_REORTH, RTOL_SHORT, SHORT_STEPS = 1e-10, 1e-8, 6


def _problem(n=40, noise=1e-3):
    """heat, with R right-hand sides: other noise and other scales."""
    A, b, x = (np.asarray(a) for a in jonedim.generate_test_problem(
        "heat", n, dtype=jnp.float64))
    rng = np.random.default_rng(0)
    cols = []
    for r in range(R):
        e = rng.standard_normal(n)
        cols.append((1.0 + r) * (b + noise * np.linalg.norm(b)
                                 / np.linalg.norm(e) * e))
    X = np.stack([(1.0 + r) * x for r in range(R)], axis=1)
    return A, np.stack(cols, axis=1), X


def _j(v):
    return jnp.asarray(v) if isinstance(v, np.ndarray) else v


def _t(v):
    return torch.from_numpy(v) if isinstance(v, np.ndarray) else v


def _run(name, A, B, X, **kw):
    jfn, tfn, _, base = SOLVERS[name]
    kw = {**base, **kw}
    jr = jfn(_j(A), _j(B), _j(X), **{k: _j(v) for k, v in kw.items()})
    tr = tfn(_t(A), _t(B), _t(X), **{k: _t(v) for k, v in kw.items()})
    return jr, tr


def _assert_match(want_r, got_r, rtol, fields=FIELDS):
    for f in fields:
        want, got = getattr(want_r, f), getattr(got_r, f)
        if want is None:
            assert got is None, f
            continue
        want = want.numpy() if isinstance(want, torch.Tensor) \
            else np.asarray(want)
        got = got.numpy()
        assert want.shape == got.shape, f
        np.testing.assert_array_equal(np.isnan(want), np.isnan(got), f)
        if np.isnan(want).all():
            continue
        np.testing.assert_allclose(
            got, want, rtol=0, atol=rtol * np.nanmax(np.abs(want)),
            equal_nan=True, err_msg=f)


def _assert_identical(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x.numpy(), y.numpy(), f)
    assert len(a.state.carry) == len(b.state.carry)
    for i, (c, d) in enumerate(zip(a.state.carry, b.state.carry)):
        np.testing.assert_array_equal(c.numpy(), d.numpy(), f"carry {i}")
    for f in ("res_hist", "err_hist", "fp"):
        np.testing.assert_array_equal(getattr(a.state, f).numpy(),
                                      getattr(b.state, f).numpy(), f)


@pytest.mark.parametrize("reorth", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_batched_matches_jax(name, reorth):
    """x (n, R), the (maxit, R) histories, niters (R,), and the carry in the
    JAX order and axis layout (bases (space, maxit+1, R))."""
    A, B, X = _problem()
    maxit = 12 if reorth else SHORT_STEPS
    jr, tr = _run(name, A, B, X, tol=0.0, maxit=maxit, reorth=reorth)
    assert tr.niters.tolist() == [maxit] * R
    assert tr.niters.dtype == torch.int32
    _assert_match(jr, tr, RTOL_REORTH if reorth else RTOL_SHORT)
    assert len(tr.state.carry) == len(jr.state.carry)
    for c, d in zip(jr.state.carry, tr.state.carry):
        assert tuple(np.shape(c)) == tuple(d.shape)
    np.testing.assert_array_equal(np.asarray(jr.state.fp),
                                  tr.state.fp.numpy())


@pytest.mark.parametrize("name", NAMES)
def test_batched_columns_match_the_single_rhs_solver(name):
    """Column j of the batched run against the port's single-RHS solve of
    right-hand side j, x0 included: the same recurrences with ``bmm`` in
    place of ``gemv`` (rtol 1e-10 with reorth, 12 steps)."""
    A, B, X = _problem()
    _, tfn, single, base = SOLVERS[name]
    x0 = 0.8 * X
    kw = dict(tol=0.0, maxit=12, reorth=True, **base)
    tr = tfn(_t(A), _t(B), _t(X), x0=_t(x0), **kw)
    for j in range(R):
        sj = single(_t(A), _t(B[:, j].copy()), _t(X[:, j].copy()),
                    x0=_t(x0[:, j].copy()), **kw)
        for f in FIELDS:
            if getattr(sj, f) is None:
                continue
            got = getattr(tr, f)[..., j].numpy()
            want = getattr(sj, f).numpy()
            np.testing.assert_allclose(
                got, want, rtol=0, atol=1e-10 * np.abs(want).max(),
                err_msg=f"{f}[{j}]")


@pytest.mark.parametrize("name", NAMES)
def test_batched_warm_start_matches_jax(name):
    """``x0`` as (n, R) and as one (n,) vector broadcast to every RHS."""
    A, B, X = _problem()
    for x0 in (0.8 * X, 0.8 * X[:, 0].copy()):
        jr, tr = _run(name, A, B, X, tol=0.0, maxit=8, reorth=True, x0=x0)
        _assert_match(jr, tr, RTOL_REORTH)
        np.testing.assert_allclose(tr.state.fp.numpy(),
                                   np.asarray(jr.state.fp), rtol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_per_rhs_early_exit_and_breakdown_match_jax(name):
    """Each RHS stops on its own: a zero column adopts nothing (niters 0,
    NaN history, no wrapped patch index), column 0 meets a tolerance set
    between its residuals of steps 4 and 5 and freezes there with NaN
    beyond, and the others run on or stop where the JAX package stops
    them."""
    A, B, X = _problem()
    B[:, 1] = 0.0
    _, tfn, _, base = SOLVERS[name]
    res = tfn(_t(A), _t(B), _t(X), tol=0.0, maxit=10, reorth=True,
              **base).state.res_hist.numpy()
    tol = float(np.sqrt(res[3, 0] * res[4, 0]))
    jr, tr = _run(name, A, B, X, tol=tol, maxit=10, reorth=True)
    niters = tr.niters.tolist()
    assert niters == np.asarray(jr.niters).tolist()
    assert niters[1] == 0 and 0 < niters[0] < 10
    assert np.isnan(tr.res_hist[:, 1].numpy()).all()
    _assert_match(jr, tr, RTOL_REORTH)


def test_no_x_true_and_shape_errors():
    A, B, X = _problem()
    for name in NAMES:
        jr, tr = _run(name, A, B, None, tol=0.0, maxit=4)
        assert np.isnan(tr.err_hist.numpy()).all()
        _assert_match(jr, tr, RTOL_SHORT)
        with pytest.raises(ValueError, match=r"\(m, R\)"):
            SOLVERS[name][1](_t(A), _t(B[:, 0].copy()), maxit=2)
    for lam in (np.ones(R + 1), np.ones((R, 1))):
        with pytest.raises(ValueError, match="lam must be"):
            tgkb.hybrid_lsqr_batched(_t(A), _t(B), maxit=2, lam=_t(lam))


def test_hybrid_lsqr_batched_per_rhs_lam():
    """An (R,) ``lam``: each column gets its own Tikhonov weight (against
    JAX and against the scalar solves of each column); a vector whose
    entries are all equal gives the scalar call's numbers exactly."""
    A, B, X = _problem()
    lam = np.array([1e-4, 1e-3, 1e-2])
    jr, tr = _run("hybrid_lsqr_batched", A, B, X, tol=0.0, maxit=10,
                  reorth=True, lam=lam)
    _assert_match(jr, tr, RTOL_REORTH)
    for j in range(R):
        sj = tlsqr.hybrid_lsqr(_t(A), _t(B[:, j].copy()), _t(X[:, j].copy()),
                               tol=0.0, maxit=10, reorth=True,
                               lam=float(lam[j]))
        np.testing.assert_allclose(tr.res_hist[:, j].numpy(),
                                   sj.res_hist.numpy(), rtol=1e-9)
    kw = dict(tol=0.0, maxit=10, reorth=True)
    same = tgkb.hybrid_lsqr_batched(_t(A), _t(B), _t(X),
                                    lam=torch.full((R,), 1e-3,
                                                   dtype=torch.float64), **kw)
    scalar = tgkb.hybrid_lsqr_batched(_t(A), _t(B), _t(X), lam=1e-3, **kw)
    for f in ("x", "res_hist", "err_hist"):
        np.testing.assert_array_equal(getattr(same, f).numpy(),
                                      getattr(scalar, f).numpy())


@pytest.mark.parametrize("x0", [False, True])
@pytest.mark.parametrize("reorth", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_batched_resume_equals_uninterrupted_exactly(name, reorth, x0):
    """resume(run(maxit=5), maxit=11) == run(maxit=11) bit for bit on the
    CPU, with a frozen (zero) column among the right-hand sides."""
    A, B, X = _problem(noise=1e-2)
    B[:, 2] = 0.0
    _, tfn, _, base = SOLVERS[name]
    kw = dict(tol=0.0, reorth=reorth, **base)
    if x0:
        kw["x0"] = _t(0.9 * X[:, 0].copy())
    args = (_t(A), _t(B), _t(X))
    part = tfn(*args, maxit=5, **kw)
    before = [c.clone() for c in part.state.carry]
    full = tfn(*args, maxit=11, **kw)
    resumed = tfn(*args, maxit=11, resume_from=part.state, **kw)
    _assert_identical(resumed, full)
    for c, d in zip(before, part.state.carry):   # the checkpoint is intact
        np.testing.assert_array_equal(c.numpy(), d.numpy())


@pytest.mark.parametrize("via", ["convert", "npz"])
@pytest.mark.parametrize("name", NAMES)
def test_batched_resume_of_a_jax_state_matches_jax(name, via, tmp_path):
    """A batched state made by the JAX package (maxit=5, reorth, a per-RHS
    ``lam`` for hybrid LSQR) continues in the port to maxit=10 and gives
    the JAX package's uninterrupted run, through ``gkb_state_from_numpy``
    or the JAX ``.npz``; the port's own ``.npz`` resumes in JAX."""
    A, B, X = _problem(noise=1e-2)
    jfn, tfn, _, base = SOLVERS[name]
    kw = dict(tol=0.0, reorth=True, **base)
    if name == "hybrid_lsqr_batched":
        kw["lam"] = np.array([1e-4, 1e-3, 1e-2])
    jkw = {k: _j(v) for k, v in kw.items()}
    tkw = {k: _t(v) for k, v in kw.items()}
    jargs, targs = (_j(A), _j(B), _j(X)), (_t(A), _t(B), _t(X))
    jpart = jfn(*jargs, maxit=5, **jkw)
    jfull = jfn(*jargs, maxit=10, **jkw)
    if via == "convert":
        state = gkb_state_from_numpy(jpart.state, device="cpu")
    else:
        path = str(tmp_path / "jax_state.npz")
        jckpt.save_gkb_state(path, jpart.state)
        state = tckpt.load_gkb_state(path, device="cpu")
    tr = tfn(*targs, maxit=10, resume_from=state, **tkw)
    _assert_match(jfull, tr, 1e-8)
    if via == "npz":
        mine = str(tmp_path / "port_state.npz")
        tckpt.save_gkb_state(mine, tfn(*targs, maxit=5, **tkw).state)
        jr = jfn(*jargs, maxit=10, resume_from=jckpt.load_gkb_state(mine),
                 **jkw)
        _assert_match(jr, tr, 1e-8)


def test_grow_stored_bases_matches_jax():
    """Zero columns appended along axis 1 up to ``maxit + 1``, for (space,
    k) and (space, k, R) bases; other entries untouched."""
    from hybrid_gmres_tpu.solvers.common import grow_stored_bases as jgrow
    from hybrid_gmres_tpu_torch.solvers.common import grow_stored_bases

    rng = np.random.default_rng(3)
    carry = (rng.standard_normal(4), rng.standard_normal((5, 3)),
             rng.standard_normal((5, 3, 2)))
    want = jgrow(tuple(jnp.asarray(c) for c in carry), 6, (1, 2))
    got = grow_stored_bases(tuple(torch.from_numpy(c) for c in carry), 6,
                            (1, 2))
    assert [tuple(g.shape) for g in got] == [(4,), (5, 7), (5, 7, 2)]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    same = grow_stored_bases(got, 4, (1, 2))
    assert all(s is g for s, g in zip(same, got))


def test_batched_resume_guards():
    """Another ``lam`` vector, another reorth, or no larger budget raise."""
    A, B, X = _problem()
    args = (_t(A), _t(B), _t(X))
    lam = torch.tensor([1e-4, 1e-3, 1e-2], dtype=torch.float64)
    part = tgkb.hybrid_lsqr_batched(*args, maxit=4, lam=lam)
    tgkb.hybrid_lsqr_batched(*args, maxit=6, lam=lam, resume_from=part.state)
    other = lam.clone()
    other[1] = 1.01e-3
    with pytest.raises(ValueError, match="fingerprint"):
        tgkb.hybrid_lsqr_batched(*args, maxit=6, lam=other,
                                 resume_from=part.state)
    with pytest.raises(ValueError, match="fingerprint"):
        tgkb.hybrid_lsqr_batched(*args, maxit=6, lam=1e-3,
                                 resume_from=part.state)
    with pytest.raises(ValueError, match="reorth"):
        tgkb.hybrid_lsqr_batched(*args, maxit=6, lam=lam, reorth=True,
                                 resume_from=part.state)
    with pytest.raises(ValueError, match="maxit > 4"):
        tgkb.hybrid_lsqr_batched(*args, maxit=4, lam=lam,
                                 resume_from=part.state)
    with pytest.raises(ValueError, match="reorth"):
        tgkb.lsmr_batched(*args, maxit=6, resume_from=tgkb.lsmr_batched(
            *args, maxit=4, reorth=True).state)


@pytest.mark.parametrize("name", NAMES)
def test_batched_gkb_slice_ct16_int8_forward_panels_matches_jax(name):
    """The serving slice as a whole: CT n=16, R=3 noisy sinograms (seeds
    0..2) through the int8 block-ELL operator with its forward panel only
    in both packages (K2/K4 in interpret mode against their plain versions),
    float32, 6 steps; rtol 2e-4 of the largest entry, as for the single-RHS
    slice.  The augmented slab of hybrid LSQR goes through ``matmat_into``
    and a row slice of the slab."""
    from hybrid_gmres_tpu.problems import ct as jct
    from hybrid_gmres_tpu_torch.problems import ct as tct
    from hybrid_gmres_tpu_torch.problems.noise import add_noise

    jp = jct.ct_mismatched(n=16, n_angles=24, n_det=24, dense=False)
    jA, _, _, jx, _, _ = jct.ct_tpu_operators(jp, dtype=jnp.int8)
    jA.interpret = True
    tp = tct.ct_mismatched(n=16, n_angles=24, n_det=24)
    tA, _, _, tx, trp, _ = tct.ct_gpu_operators(tp, dtype="int8",
                                                device="cpu")
    assert jA.adj is None and tA.adj is None
    b = np.stack([add_noise(tp.b_exact, 0.25, seed=r)[0][trp]
                  for r in range(R)], axis=1).astype(np.float32)
    jfn, tfn, _, base = SOLVERS[name]
    kw = dict(tol=0.0, maxit=6, **base)
    jr = jfn(jA, jnp.asarray(b), jx.astype(jnp.float32), **kw)
    tr = tfn(tA, torch.from_numpy(b), tx.float(), **kw)
    assert tr.niters.tolist() == [6] * R and tr.x.shape == (256, R)
    assert tr.x.dtype == torch.float32
    _assert_match(jr, tr, 2e-4)
