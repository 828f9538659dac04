"""``run.py`` without a card fails and prints no result; the result
line's shape; every file a cell names is found by name."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from gpubench.lib import runner, spec
from gpubench.lib.spec import ROOT
from gpubench.tests.tiny import tiny_cell

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def _run(cwd, env_extra):
    return subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, **env_extra))


def test_no_card_no_result():
    out = _run(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_bare_directory_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "gpubench"), tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    out = _run(tmp_path, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "{" not in out.stdout


@pytest.mark.parametrize("cell", CELLS)
def test_every_piece_found_by_name(cell):
    c = spec.load_cell(cell)
    assert c["config"]["name"] == cell.split(".")[0]
    spec.reference_solver(c["traffic"]["reference"])
    assert {"setup_s"} <= {m["name"] for m in c["end_to_end"]}
    for m in c["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
    assert "failed" in c["limits"] and len(c["limits"]) >= 3


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_shape(trace):
    cell = tiny_cell("ct128_int8.frame8")
    result, judged = runner.run_cell(cell, 11, 0.3, trace, "cpu",
                                      time.perf_counter(),
                                      log=lambda m: None)
    line = runner.result_line(result, judged, "cpu rehearsal", 1)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    json.loads(json.dumps(line))
    assert line["attempted"] >= 1 and line["failed"] == 0
    names = {m["name"] for m in (cell["per_layer"] if trace
                                 else cell["end_to_end"])}
    assert set(line["metrics"]) <= names
    if trace:
        # the CPU has no device activity: the trace metrics stay silent
        assert set(line["metrics"]) == {"pack_s"}
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == names
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
