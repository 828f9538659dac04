"""PyTorch port: the whole slices (CT problem -> int8 block-ELL operators ->
hybrid BA-GMRES with the fused residual, single-RHS and batched) against the
JAX package, and the port's independence from JAX."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hybrid_gmres_tpu.problems import ct as jct
from hybrid_gmres_tpu.solvers.gmres import ba_gmres as jba
from hybrid_gmres_tpu_torch.problems import ct as tct
from hybrid_gmres_tpu_torch.solvers.gmres import ba_gmres as tba

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_ct_problem_matches_jax(backend):
    jp = jct.ct_mismatched(n=16, n_angles=24, n_det=20, dense=False,
                           backend=backend)
    tp = tct.ct_mismatched(n=16, n_angles=24, n_det=20, backend=backend)
    for name in ("A_csr", "B_csr"):
        a, b = getattr(jp, name), getattr(tp, name)
        assert a.shape == b.shape and a.nnz == b.nnz
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.data, b.data)
    np.testing.assert_array_equal(np.asarray(jp.b_exact), tp.b_exact)
    np.testing.assert_array_equal(np.asarray(jp.x_true), tp.x_true)
    np.testing.assert_array_equal(jct.shepp_logan(16), tct.shepp_logan(16))


def test_slice_ct16_int8_fused_matches_jax():
    """CT n=16 (24x24 rays) through ct_tpu_operators(int8) + the JAX solver
    (Pallas interpret mode) and ct_gpu_operators(int8) + the port's solver
    (plain K1 on CPU): identical panels, and res/err histories and x within
    rtol 1e-5 of the max entry (float32 panel products in a float64 solve,
    different summation orders, 10 Krylov steps)."""
    jp = jct.ct_mismatched(n=16, n_angles=24, n_det=24, dense=False)
    jA, jB, jb, jx, jrp, jpp = jct.ct_tpu_operators(jp, dtype=jnp.int8)
    jA.interpret = jB.interpret = True
    tp = tct.ct_mismatched(n=16, n_angles=24, n_det=24)
    tA, tB, tb, tx, trp, tpp = tct.ct_gpu_operators(tp, dtype="int8",
                                                    device="cpu")
    np.testing.assert_array_equal(jrp, trp)
    np.testing.assert_array_equal(jpp, tpp)
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
    for jo, to in ((jA, tA), (jB, tB)):
        assert to.dtype == torch.float32 and to.storage_dtype == torch.int8
        np.testing.assert_array_equal(np.asarray(jo.fwd_scale),
                                      to.fwd_scale.numpy())
        for (bj, cj), (bt, ct) in zip(jo.fwd.buckets, to.fwd.buckets):
            np.testing.assert_array_equal(np.asarray(bj), bt.numpy())
            np.testing.assert_array_equal(np.asarray(cj), ct.numpy())

    kw = dict(tol=0.0, maxit=10, lam=1e-2, residual="fused")
    jr = jba(jA, jB, jb, jx, **kw)
    tr = tba(tA, tB, tb, tx, **kw)
    assert int(tr.niters) == int(jr.niters) == 10
    for name in ("res_hist", "err_hist", "x"):
        want = np.asarray(getattr(jr, name))
        got = getattr(tr, name).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)
    np.testing.assert_array_equal(tr.fp.numpy(), np.asarray(jr.fp))


def test_batched_slice_ct16_int8_matches_jax():
    """The serving slice as a whole: CT n=16, R=3 noisy sinograms (seeds
    0..2, drawn in original ray order, then permuted) through the int8
    block-ELL operators and ``ba_gmres_batched`` of both packages (the JAX
    side runs its multi-RHS Pallas kernel in interpret mode, the port K2's
    plain version), in-loop and deferred.  Histories and x within 1e-5 of
    the max entry: float32 panel products in a float64 solve, different
    summation orders, 8 Krylov steps."""
    from hybrid_gmres_tpu.solvers.batched import ba_gmres_batched as jbb
    from hybrid_gmres_tpu_torch.problems.noise import add_noise
    from hybrid_gmres_tpu_torch.solvers.batched import ba_gmres_batched as tbb

    jp = jct.ct_mismatched(n=16, n_angles=24, n_det=24, dense=False)
    jA, jB, _, jx, jrp, _ = jct.ct_tpu_operators(jp, dtype=jnp.int8)
    jA.interpret = jB.interpret = True
    tp = tct.ct_mismatched(n=16, n_angles=24, n_det=24)
    tA, tB, _, tx, trp, _ = tct.ct_gpu_operators(tp, dtype="int8",
                                                 device="cpu")
    b = np.stack([add_noise(tp.b_exact, 0.25, seed=r)[0][trp]
                  for r in range(3)], axis=1)
    for defer in (False, True):
        kw = dict(tol=0.0, maxit=8, lam=1e-2, defer_histories=defer)
        jr = jbb(jA, jB, jnp.asarray(b), jx, **kw)
        tr = tbb(tA, tB, torch.from_numpy(b), tx, **kw)
        assert tr.niters.tolist() == np.asarray(jr.niters).tolist() == [8] * 3
        assert tr.x.shape == (256, 3) and tr.IMG.shape == (576, 8, 3)
        for name in ("res_hist", "err_hist", "x"):
            want = np.asarray(getattr(jr, name))
            got = getattr(tr, name).numpy()
            assert np.isfinite(got).all()
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=name)


def _load_script(relpath):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        os.path.splitext(os.path.basename(relpath))[0],
        os.path.join(REPO, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_jax_witness_matches_chip_smoke_host_reference():
    """The JAX-only witness behind the quality gates
    (scripts_torch/witness_ct.py) and chip_smoke.py's float64 host reference
    (port solver, scipy SpMV) solve the same int8 bench scenario at n=16:
    the port assembles the JAX arrays bit for bit, and both float64 error
    histories agree to rtol 1e-10 through the semi-convergence minimum
    (k=5 here)."""
    witness = _load_script("scripts_torch/witness_ct.py")
    smoke = _load_script("chip_smoke.py")
    jp, same = witness.check_assembly(16, 45)
    assert same
    err_jax = witness.solve(jp, quantize=True)
    _, _, b, ray_perm, pix_perm = witness.scenario(jp)
    err_port = smoke.host_reference(
        tct.ct_mismatched(n=16, n_angles=45, n_det=45), ray_perm, pix_perm, b)
    assert int(np.argmin(err_jax)) == int(np.argmin(err_port)) < 8
    np.testing.assert_allclose(err_port[:8], err_jax[:8], rtol=1e-10)


def test_port_never_imports_jax():
    """In a fresh process: import every module of the port and
    ``chip_smoke`` (without running it), run a single-RHS and a batched
    solve on the CPU, and find neither ``jax`` nor the JAX package among
    the loaded modules."""
    code = textwrap.dedent("""
        import importlib
        import pkgutil
        import sys
        import numpy as np
        import torch
        import hybrid_gmres_tpu_torch as hg
        assert "hybrid_gmres_tpu_torch.solvers" not in sys.modules  # lazy
        prob = hg.ct_mismatched(n=8, n_angles=12, n_det=12)
        A, B, b, x, _, _ = hg.ct_gpu_operators(prob, dtype="int8",
                                               device="cpu")
        r = hg.ba_gmres(A, B, b.float(), x.float(), tol=0.0, maxit=4,
                        lam=1e-2, residual="fused")
        assert torch.isfinite(r.err_hist).all()
        bb = torch.stack([b, 2 * b], dim=1).float()
        r = hg.ba_gmres_batched(A, B, bb, x.float(), maxit=4, lam=1e-2,
                                defer_histories=True)
        assert torch.isfinite(r.err_hist).all()
        names = [m.name for m in pkgutil.walk_packages(
            hg.__path__, prefix="hybrid_gmres_tpu_torch.")]
        assert len(names) > 20, names
        for name in names:
            importlib.import_module(name)
        for name in hg.__all__:
            getattr(hg, name)
        import chip_smoke
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib",
                                                    "hybrid_gmres_tpu.")))
        assert not bad and "hybrid_gmres_tpu" not in sys.modules, bad
        print("ok")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def _port_sources(with_smoke=True):
    pkg = os.path.join(REPO, "hybrid_gmres_tpu_torch")
    for root, _, files in os.walk(pkg):
        if "_build" in root.split(os.sep):
            continue
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    yield os.path.join(root, f), fh.read()
    if with_smoke:
        with open(os.path.join(REPO, "chip_smoke.py")) as fh:
            yield "chip_smoke.py", fh.read()


def test_port_sources_have_no_jax_import():
    for path, src in _port_sources():
        assert "import jax" not in src and "from jax" not in src, path


def test_port_reads_no_file_of_the_jax_package():
    """No string that the package's code computes with names the JAX
    package or a path into it (docstrings may cite the reference, and
    ``chip_smoke.py`` records which TPU kernel each kernel replaces); the CT
    assembler is built from the port's own copy of the source, which is the
    reference's byte for byte."""
    import ast
    import re

    into_jax = re.compile(r"hybrid_gmres_tpu(?!_torch)")
    for path, src in _port_sources(with_smoke=False):
        tree = ast.parse(src)
        docstrings = {
            id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and id(node) not in docstrings:
                assert not into_jax.search(node.value), (path, node.value)
    from hybrid_gmres_tpu_torch.utils import native

    assert native._CT_BUILDER_SRC.startswith(
        os.path.join(REPO, "hybrid_gmres_tpu_torch") + os.sep)
    with open(native._CT_BUILDER_SRC, "rb") as mine, open(os.path.join(
            REPO, "hybrid_gmres_tpu", "native", "ct_builder.cpp"),
            "rb") as ref:
        assert mine.read() == ref.read()
