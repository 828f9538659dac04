"""PyTorch port: the three experiment drivers of the lambda-choice path
(``ptr_rtp``, ``regularization``, ``gcv_surface_exp``) against the JAX
package's at the sizes of its own ``tests/test_experiments.py``, and the
port's public names against the JAX package's.

Float64 on the CPU (``Config(device="cpu", dtype="float64")``), the same
seeded problems.  Histories at rtol 1e-10, regularized solutions and the
L-curve norms at 1e-8, GCV values at 1e-9, a grid selection exactly.
"""

import functools

import numpy as np
import pytest

from hybrid_gmres_tpu.experiments import gcv_surface_exp as jgs
from hybrid_gmres_tpu.experiments import ptr_rtp as jpr
from hybrid_gmres_tpu.experiments import regularization as jreg
from hybrid_gmres_tpu_torch.experiments import gcv_surface_exp as tgs
from hybrid_gmres_tpu_torch.experiments import ptr_rtp as tpr
from hybrid_gmres_tpu_torch.experiments import regularization as treg
from hybrid_gmres_tpu_torch.experiments.common import host

CPU = dict(device="cpu", dtype="float64")
REG = dict(n=16, n_lambda=20, maxit=16, k_gcv=10)


@functools.lru_cache(maxsize=None)
def _regularization():
    """Both packages' regularization drivers at the JAX test's size."""
    return (jreg.run(jreg.Config(**REG)),
            treg.run(treg.Config(**REG, **CPU)))


def _figures(module, res, tmp_path):
    pytest.importorskip("matplotlib")
    paths = module.figures(res, str(tmp_path))
    assert paths and all(p.endswith(".png") for p in paths)


def test_ptr_rtp_driver_matches_jax(tmp_path):
    """deriv2 n=16, B = A^T: the four error histories (PTR != RTP)."""
    want = jpr.run(jpr.Config(n=16))
    got = tpr.run(tpr.Config(n=16, **CPU))
    assert sorted(got.err_hists) == sorted(want.err_hists)
    for name, hist in want.err_hists.items():
        assert got.err_hists[name].shape == hist.shape, name
        np.testing.assert_allclose(got.err_hists[name], hist, rtol=1e-10,
                                   err_msg=name)
    d = np.abs(got.err_hists["ba_ptr"][:10] - got.err_hists["ba_rtp"][:10])
    assert d.max() > 1e-8
    _figures(tpr, got, tmp_path)


def test_regularization_driver_matches_jax(tmp_path):
    """shaw n=16, 20 lambdas, maxit=16, k_gcv=10: the L-curve sweeps, the
    GCV lambdas and the final solutions.

    The GCV lambda of 'ab' sits on a bottom that is flat to the
    objective's rounding: the packages' last-bit differences steer Brent to
    points 1.3e-6 apart (measured), as good as each other, so it is held to
    5e-6 and its GCV value to 1e-10.  The non-hybrid solutions are
    unregularized GMRES on shaw after 16 steps (condition number ~1e18):
    they agree only to 2e-3 of their largest entry (measured) and are held
    to 1e-2; the regularized ones to 1e-8."""
    want, got = _regularization()
    for v in ("ab", "ba"):
        for name in ("lam_grid", "res_norms", "sol_norms", "err_norms",
                     "lam_true_opt", "err_min"):
            np.testing.assert_allclose(
                host(getattr(got.sweeps[v], name)),
                np.asarray(getattr(want.sweeps[v], name)), rtol=1e-8,
                err_msg=f"{v} {name}")
        assert 1e-9 <= got.gcv_lambdas[v] <= 1e-1
        np.testing.assert_allclose(got.gcv_lambdas[v], want.gcv_lambdas[v],
                                   rtol=5e-6)
    for name, x in want.solutions.items():
        tol = 1e-8 if name.startswith("hybrid") else 1e-2
        np.testing.assert_allclose(got.solutions[name], x, rtol=0,
                                   atol=tol * np.abs(x).max(), err_msg=name)
    np.testing.assert_array_equal(got.x_true, want.x_true)
    _figures(treg, got, tmp_path)


def test_regularization_gcv_lambdas_are_equally_good():
    """The port's GCV lambda of each variant is a minimizer of the JAX
    package's own GCV objective to 1e-10 of its value."""
    import jax.numpy as jnp

    from hybrid_gmres_tpu.problems import (add_noise, generate_test_problem,
                                           perturb_backprojector)
    from hybrid_gmres_tpu.reg.gcv import gcv_curve

    want, got = _regularization()
    A, b_exact, _ = generate_test_problem("shaw", 16)
    b, _ = add_noise(b_exact, 1e-2, seed=0)
    B, _ = perturb_backprojector(A, 1e-4, seed=0)
    for v in ("ab", "ba"):
        vals = np.asarray(gcv_curve(v, A, B, b, 10, jnp.asarray(
            [got.gcv_lambdas[v], want.gcv_lambdas[v]])))
        np.testing.assert_allclose(vals[0], vals[1], rtol=1e-10)


def test_gcv_surface_driver_matches_jax(tmp_path):
    """shaw n=16, 15 lambdas, k = 1..16: both surfaces and argmin paths."""
    cfg = dict(n=16, n_lambda=15)
    want = jgs.run(jgs.Config(**cfg))
    got = tgs.run(tgs.Config(**cfg, **CPU))
    np.testing.assert_array_equal(got.lam_grid, want.lam_grid)
    for v in ("ab", "ba"):
        assert got.surfaces[v].shape == (15, 16)
        np.testing.assert_allclose(got.surfaces[v], want.surfaces[v],
                                   rtol=1e-9)
        np.testing.assert_array_equal(got.paths[v], want.paths[v])
    _figures(tgs, got, tmp_path)


def test_port_names_cover_the_jax_package():
    """Every public name of the JAX package (its ``__all__``, its solvers'
    and its ``reg``'s) imports from the port's counterpart, every driver of
    its ``experiments`` is listed (``phantom2d_tpu`` as ``phantom2d_gpu``),
    and its ``analysis`` names have the port's own counterparts."""
    import hybrid_gmres_tpu as jhg
    import hybrid_gmres_tpu.reg as jreg_pkg
    import hybrid_gmres_tpu.solvers as jsolvers
    import hybrid_gmres_tpu_torch as thg
    import hybrid_gmres_tpu_torch.experiments as texp
    import hybrid_gmres_tpu_torch.reg as treg_pkg
    import hybrid_gmres_tpu_torch.solvers as tsolvers

    for jmod, tmod in ((jhg, thg), (jsolvers, tsolvers),
                       (jreg_pkg, treg_pkg)):
        missing = set(jmod.__all__) - set(tmod.__all__)
        assert not missing, (tmod.__name__, sorted(missing))
        for name in jmod.__all__:
            assert callable(getattr(tmod, name)), (tmod.__name__, name)
    for name in treg_pkg.__all__:
        assert getattr(thg, name) is getattr(treg_pkg, name)
    # every driver, with the JAX package's TPU driver's counterpart on the
    # card in its place, and the analysis names
    import hybrid_gmres_tpu.analysis as janalysis
    import hybrid_gmres_tpu.experiments as jexp
    import hybrid_gmres_tpu_torch.analysis as tanalysis

    rename = {"phantom2d_tpu": "phantom2d_gpu"}
    jdrivers = jexp.__all__ + ["phantom2d_tpu"]
    assert texp.__all__ == [rename.get(d, d) for d in jdrivers]
    for name in texp.__all__:
        assert callable(getattr(texp, name).run), name
    assert tanalysis.__all__ == janalysis.__all__
    for name in tanalysis.__all__:
        assert getattr(tanalysis, name) is not getattr(janalysis, name)
