"""PyTorch port: the eight experiment drivers of the rest of
``experiments/`` and the CLI, against the JAX package at the sizes of its own
``tests/test_experiments.py``.

Float64 on the CPU for the dense drivers (``Config(device="cpu",
dtype="float64")``, the same seeded problems); ``phantom2d_gpu`` on the CPU
against the JAX ``phantom2d_tpu`` with the same explicit ``Config``.

Tolerances, each with its measured reason where it is looser than 1e-8:
  * GMRES error and residual histories to 1e-8 relative over the first 12
    steps (measured <= 5e-13), but unregularized GMRES on shaw (the
    filter-factor driver's non-hybrid runs) over the first 10 (9.2e-8 at
    step 12: the projected least-squares solve of an ill-conditioned H
    amplifies the packages' last-bit differences);
  * the histories of the short GKB recurrences (LSQR, LSMR) to 1e-8 over
    the first 5 steps on deriv2 and the first 7 on the CT pair: in float64
    they lose orthogonality on these ill-posed problems, and the last-bit
    differences grow about 1000x a step (measured 2e-9 at step 5, 7e-5 to
    2e-2 at step 6 on deriv2; 8e-10 at step 7, 3e-8 at step 8 on CT);
  * GCV lambdas (bounded Brent, tolerance 1e-8 on lambda) to 1e-5 relative
    or 1e-8 absolute (measured 1.3e-6 relative on the flat bottom of the
    objective), and the final errors of the solves at those lambdas to
    1e-6 (measured 5.3e-7);
  * grid selections (the error surface's optimum) exactly.
"""

import functools
import importlib
import json
import os

import numpy as np
import pytest
import torch

CPU = dict(device="cpu", dtype="float64")
# the JAX tests' small configurations (tests/test_experiments.py)
SMALL = {
    "equivalence": dict(n=16),
    "error_surface": dict(n=16, n_lambda=12),
    "filter_factors_exp": dict(n=16),
    "perturbation_bounds": dict(n=16),
    "noise_sweep": dict(n=16, n_levels=4, maxit=16, k_gcv=8),
    "mismatch_sweep": dict(n=16, n_scales=4, maxit=16, k_gcv=8),
    "phantom2d": dict(n=16, n_angles=24, n_det=24, maxit=20,
                      n_mismatch_levels=2),
}
PHANTOM_GPU = dict(n=16, n_angles=24, n_det=24, maxit=20, R=2)


def _modules(name):
    return (importlib.import_module(f"hybrid_gmres_tpu.experiments.{name}"),
            importlib.import_module(
                f"hybrid_gmres_tpu_torch.experiments.{name}"))


@functools.lru_cache(maxsize=None)
def _runs(name):
    """(JAX result, port result) of one driver at its small config."""
    jmod, tmod = _modules(name)
    return (jmod.run(jmod.Config(**SMALL[name])),
            tmod.run(tmod.Config(**SMALL[name], **CPU)))


def _hist(got, want, steps, rtol=1e-8, label=""):
    assert got.shape == want.shape, label
    np.testing.assert_allclose(got[:steps], want[:steps], rtol=rtol,
                               err_msg=label)


def _close(got, want, tol, label=""):
    """Within ``tol`` of the reference's largest entry."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, label
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max(), err_msg=label)


def _skip_on_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the error raised without a CUDA device")


def _figures(module, res, tmp_path):
    pytest.importorskip("matplotlib")
    paths = module.figures(res, str(tmp_path))
    assert paths and all(p.endswith(".png") for p in paths)
    return paths


def test_equivalence_driver_matches_jax(tmp_path):
    """deriv2 n=16, B = A^T: the eight histories and solutions, and the
    reference's (==) / (!=) pairs on the port's own results."""
    want, got = _runs("equivalence")
    gkb = ("lsmr", "lsqr")
    for name, hist in want.err_hists.items():
        _hist(got.err_hists[name], hist, 5 if name in gkb else 12,
              label=name)
        # GKB solutions after 16 steps: the drift above (2.3e-6, measured)
        _close(got.solutions[name], want.solutions[name],
               1e-4 if name in gkb else 1e-8, name)
    np.testing.assert_array_equal(got.x_true, want.x_true)
    for a, b in (("ba_gmres", "lsmr"), ("ab_gmres", "lsqr")):
        np.testing.assert_allclose(got.err_hists[a][:4], got.err_hists[b][:4],
                                   rtol=1e-6)
    np.testing.assert_allclose(got.solutions["hybrid_ba"],
                               got.solutions["hybrid_lsmr"], rtol=1e-6)
    assert np.linalg.norm(got.solutions["hybrid_ab"]
                          - got.solutions["hybrid_lsqr"]) > 1e-8
    _figures(_modules("equivalence")[1], got, tmp_path)


def test_error_surface_driver_matches_jax(tmp_path):
    """deriv2 n=16, 12 lambdas: the (lambda, k) surfaces (one solve per
    lambda in the port, one vmapped solve in JAX; measured 1.5e-14) and
    the optima, the same grid point."""
    want, got = _runs("error_surface")
    np.testing.assert_array_equal(got.lam_grid, want.lam_grid)
    for v in ("ab", "ba"):
        assert got.surfaces[v].shape == (12, 16)
        np.testing.assert_allclose(got.surfaces[v], want.surfaces[v],
                                   rtol=1e-8)
        k, lam, err = got.optima[v]
        assert (k, lam) == want.optima[v][:2]
        np.testing.assert_allclose(err, want.optima[v][2], rtol=1e-8)
        assert err == np.nanmin(got.surfaces[v])
    _figures(_modules("error_surface")[1], got, tmp_path)


def test_filter_factors_driver_matches_jax(tmp_path):
    """shaw n=16: histories of the four variants; the hybrid variants'
    theoretical and empirical filter factors to 1e-8 (measured 6e-14).  The
    non-hybrid factors come from the final, unregularized step (k = n),
    where the theta pencil is as ill-conditioned as shaw: there only their
    shape is held."""
    want, got = _runs("filter_factors_exp")
    for name in ("ab", "ba", "hybrid_ab", "hybrid_ba"):
        steps = 12 if name.startswith("hybrid") else 10
        _hist(got.err_hists[name], want.err_hists[name], steps, label=name)
        _hist(got.res_hists[name], want.res_hists[name], steps, label=name)
        for field in ("phi_theory", "phi_empirical"):
            g, w = getattr(got, field)[name], getattr(want, field)[name]
            assert g.shape == w.shape, (field, name)
            if name.startswith("hybrid"):
                _close(g, w, 1e-8, f"{field} {name}")
    _figures(_modules("filter_factors_exp")[1], got, tmp_path)


def test_perturbation_bounds_driver_matches_jax(tmp_path):
    """shaw n=16, hybrid AB and BA: the actual changes of the filter
    factors and their first-order bounds (measured equal to the bit)."""
    want, got = _runs("perturbation_bounds")
    for name in ("hybrid_ab", "hybrid_ba"):
        _close(got.actual[name], want.actual[name], 1e-8, name)
        _close(got.bound[name], want.bound[name], 1e-8, name)
    _figures(_modules("perturbation_bounds")[1], got, tmp_path)


@pytest.mark.parametrize("name", ["noise_sweep", "mismatch_sweep"])
def test_sweep_driver_matches_jax(name, tmp_path):
    """shaw (noise) / heat (mismatch) n=16 at 4 levels: the GCV lambda per
    level and the final errors.  The non-hybrid final errors are
    unregularized GMRES on shaw after 16 steps, of order 1e12: they are held
    to the same order of magnitude only (measured 2.1e-2 apart)."""
    want, got = _runs(name)
    axis = "noise_levels" if name == "noise_sweep" else "mismatch_norms"
    np.testing.assert_allclose(getattr(got, axis), getattr(want, axis),
                               rtol=1e-12)
    for v in ("ab", "ba"):
        np.testing.assert_allclose(got.gcv_lambdas[v], want.gcv_lambdas[v],
                                   rtol=1e-5, atol=1e-8, err_msg=v)
    assert sorted(got.final_errors) == sorted(want.final_errors)
    for k, e in want.final_errors.items():
        g = got.final_errors[k]
        assert np.all(np.isfinite(g)), k
        if k.startswith("hybrid"):
            np.testing.assert_allclose(g, e, rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_allclose(np.log10(g), np.log10(e), atol=0.3,
                                       err_msg=k)
    _figures(_modules(name)[1], got, tmp_path)


def test_phantom2d_driver_matches_jax(tmp_path):
    """CT n=16, 24x24, maxit=20, two mismatch levels: the four methods'
    histories and reconstructions, and the sweep.  The hybrid methods are
    LSQR on the composed operator (the GKB drift above): their
    reconstructions after 20 steps are held to 1e-2 (measured 7.4e-3), the
    final errors of the sweep to 1e-2 (5.3e-3)."""
    want, got = _runs("phantom2d")
    for name, hist in want.err_hists.items():
        hybrid = name.startswith("hybrid")
        _hist(got.err_hists[name], hist, 7 if hybrid else 12, label=name)
        _close(got.reconstructions[name], want.reconstructions[name],
               1e-2 if hybrid else 1e-6, name)
        np.testing.assert_allclose(
            got.mismatch_errors[name], want.mismatch_errors[name],
            rtol=1e-2 if hybrid else 1e-8, err_msg=name)
    np.testing.assert_allclose(got.b_noise, want.b_noise, rtol=1e-12)
    np.testing.assert_array_equal(got.mismatch_levels, want.mismatch_levels)
    assert len(_figures(_modules("phantom2d")[1], got, tmp_path)) == 4


@functools.lru_cache(maxsize=None)
def _phantom_gpu(dtype):
    from hybrid_gmres_tpu_torch.experiments import phantom2d_gpu

    return phantom2d_gpu.run(phantom2d_gpu.Config(
        **PHANTOM_GPU, device="cpu", dtype=dtype))


def test_phantom2d_gpu_dense_matches_jax(tmp_path):
    """The card's driver on the CPU with dense float32 operators against
    the JAX ``phantom2d_tpu`` with the same explicit Config (its off-chip
    dense operators).  The JAX driver assembles them in the session's
    default float, float64 under these tests, on a float32 sinogram; the
    port's are float32: the error histories agree to 6.8e-6 over the
    first 12 steps (measured) and are held to 2e-5 there, the minima to
    1e-5; past the minimum the under-regularized steps drift apart."""
    from hybrid_gmres_tpu.experiments import phantom2d_tpu
    from hybrid_gmres_tpu_torch.experiments import phantom2d_gpu

    want = phantom2d_tpu.run(phantom2d_tpu.Config(**PHANTOM_GPU))
    got = _phantom_gpu("dense-f32")
    assert got.backend == want.backend == "cpu"
    assert got.cfg == phantom2d_gpu.Config(**PHANTOM_GPU, device="cpu",
                                           dtype="dense-f32")
    _hist(got.err_hist, want.err_hist, 12, rtol=2e-5)
    _hist(got.batched_err_hists, np.asarray(want.batched_err_hists), 12,
          rtol=2e-5)
    for field in ("min_err", "batched_min_err_worst"):
        np.testing.assert_allclose(getattr(got, field), getattr(want, field),
                                   rtol=1e-5, err_msg=field)
    for field in ("niters", "warm_iters_to_gate", "cold_iters_to_gate",
                  "gate"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.recon.shape == (16, 16) and got.sino.shape == (24, 24)
    np.testing.assert_array_equal(got.sino, want.sino)
    assert got.it_per_s > 0
    _figures(phantom2d_gpu, got, tmp_path)


def test_phantom2d_gpu_int8_on_the_cpu_keeps_its_config():
    """``dtype="int8"`` on the CPU runs the int8 Morton-ordered operators
    through the plain versions, at the Config given (nothing shrinks,
    nothing switches to dense): held to the dense run within the int8
    quantization band (per-row int8, <= 1/254 of each row's largest entry;
    measured 1.3e-3 over the first 12 steps, held to 5e-3)."""
    got, dense = _phantom_gpu("int8"), _phantom_gpu("dense-f32")
    assert got.cfg.dtype == "int8" and got.cfg.n == 16
    assert got.err_hist.shape == (20,)
    _hist(got.err_hist, dense.err_hist, 12, rtol=5e-3)
    np.testing.assert_allclose(got.min_err, dense.min_err, rtol=5e-3)
    np.testing.assert_allclose(got.batched_min_err_worst,
                               dense.batched_min_err_worst, rtol=5e-3)
    _close(got.recon, dense.recon, 5e-2, "recon")


def test_phantom2d_gpu_rejects_other_dtypes():
    from hybrid_gmres_tpu_torch.experiments import phantom2d_gpu

    with pytest.raises(ValueError, match="dtype"):
        phantom2d_gpu.run(phantom2d_gpu.Config(**PHANTOM_GPU, device="cpu",
                                               dtype="float64"))


@pytest.mark.parametrize("name", sorted(SMALL) + ["phantom2d_gpu"])
def test_drivers_default_to_the_card(name):
    """Every driver's Config asks for the card; without one it raises
    instead of running on the CPU."""
    tmod = importlib.import_module(
        f"hybrid_gmres_tpu_torch.experiments.{name}")
    assert tmod.Config().device == "cuda"
    _skip_on_a_card()
    with pytest.raises(RuntimeError, match="CUDA"):
        tmod.run()


def test_cli_lists_the_jax_drivers_with_the_one_rename(capsys):
    from hybrid_gmres_tpu.experiments import __main__ as jcli
    from hybrid_gmres_tpu_torch.experiments import __main__ as tcli

    assert tcli.main(["--list"]) == 0
    listed = capsys.readouterr().out.split()
    rename = {"phantom2d_tpu": "phantom2d_gpu"}
    assert listed == tcli.DRIVERS == [rename.get(d, d) for d in jcli.DRIVERS]
    assert tcli._JSON_KEY == jcli._JSON_KEY


def _figures_dir_state():
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "figures")
    return {f: os.stat(os.path.join(root, f)).st_mtime_ns
            for f in sorted(os.listdir(root))}


def test_cli_cpu_run_writes_the_jax_keys(tmp_path):
    """``--cpu equivalence`` into ``tmp_path``: the entry has the keys of
    the JAX package's ``figures/results.json`` entry, its soldiffs agree
    with those float64 values (the hybrid pairs to 1e-6; the non-hybrid
    pairs hold LSQR and LSMR after 32 steps, which drift as above: to 1e-2,
    measured 2.3e-3), a stale key is pruned, and
    ``figures/`` is left untouched."""
    from hybrid_gmres_tpu_torch.experiments import __main__ as tcli

    before = _figures_dir_state()
    path = tmp_path / "results.json"
    path.write_text(json.dumps({"stale_driver": {"x": 1.0},
                                "ptr_rtp": {"ba_ptr": 0.5}}))
    assert tcli.main(["--cpu", "equivalence", "--outdir",
                      str(tmp_path)]) == 0
    results = json.loads(path.read_text())
    assert set(results) == {"equivalence", "ptr_rtp"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "figures", "results.json")) as f:
        jax_results = json.load(f)
    got, want = results["equivalence"], jax_results["equivalence"]
    assert set(got) == set(want)
    for k, v in want.items():
        if k.endswith("_soldiff"):
            tight = k.startswith("hybrid")
            np.testing.assert_allclose(got[k], v, rtol=1e-6 if tight
                                       else 1e-2, atol=1e-14, err_msg=k)
    if importlib.util.find_spec("matplotlib"):
        assert got["figures"] == want["figures"]
    assert _figures_dir_state() == before


def test_cli_defaults_to_the_card(tmp_path):
    from hybrid_gmres_tpu_torch.experiments import __main__ as tcli

    _skip_on_a_card()
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["equivalence", "--outdir", str(tmp_path)])
    assert not (tmp_path / "results.json").exists()
