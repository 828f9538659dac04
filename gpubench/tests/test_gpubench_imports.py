"""No run imports JAX or the JAX package; the harness reads nothing of the
repo's older measuring scripts; the reference imports nothing of the
program."""

import ast
import os
import subprocess
import sys

import pytest

from gpubench.lib import env
from gpubench.lib.spec import BENCH, ROOT

OLD_SCRIPTS = {"bench", "chip_smoke", "scripts", "scripts_torch"}


def _sources(*parts):
    top = os.path.join(BENCH, *parts)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "import_module":
            for arg in node.args:
                if isinstance(arg, ast.Constant):
                    yield arg.value


@pytest.mark.parametrize("name, flagged", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("hybrid_gmres_tpu", True),
    ("hybrid_gmres_tpu.ops.spmv_pallas", True),
    ("hybrid_gmres_tpu_torch", False),
    ("hybrid_gmres_tpu_torch.solvers", False), ("jaxtyping", False),
    ("torch", False)])
def test_top_level_names_are_compared_whole(name, flagged):
    assert bool(env.forbidden_modules([name])) is flagged


def test_sources_import_neither_jax_nor_old_scripts():
    for path in _sources():
        for mod in _imported(path):
            top = mod.split(".")[0]
            assert top not in env.FORBIDDEN, (path, mod)
            assert top not in OLD_SCRIPTS, (path, mod)


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        for mod in _imported(path):
            assert mod.split(".")[0] in ("torch", "math", "warnings",
                                         "__future__",
                                         "gpubench"), (path, mod)
            assert not mod.startswith("gpubench.lib"), (path, mod)


def test_a_run_loads_no_jax():
    """A whole tiny run on the CPU, in a fresh process, then its modules."""
    code = (
        "import sys, time\n"
        "from gpubench.lib import env, runner\n"
        "from gpubench.tests.tiny import tiny_cell\n"
        "cell = tiny_cell('ct128_int8.rtp1')\n"
        "runner.run_cell(cell, 7, 0.2, False, 'cpu', time.perf_counter(),"
        " log=lambda m: None)\n"
        "print('FOUND', env.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout
