"""Find every piece of a cell by name.

``BENCHMARK.json`` at the checkout's root names a cell's configuration and
traffic mix; each is a data file of its own
(``gpubench/configs/<config>.json``, ``gpubench/traffic/<mix>.json``), and
so are the limits of the cell's output check
(``gpubench/limits/<cell>.json``), the reference solver a mix names
(``gpubench/reference/<name>.py``) and the reader of each per-layer metric
(``gpubench/metrics/<metric>.py``).  Adding any of them is adding a file.
"""

from __future__ import annotations

import importlib
import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark():
    return _json(ROOT, "BENCHMARK.json")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str) -> dict:
    """The cell ``name`` with its configuration, traffic mix, limits and
    the metrics it reports."""
    spec = benchmark()
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; known: "
                         f"{sorted(cells)}")
    cell = cells[name]
    return dict(
        name=name, chips=cell["chips"],
        config=config(cell["config"]), traffic=traffic(cell["traffic"]),
        limits=_json(BENCH, "limits", f"{name}.json"),
        end_to_end=[m for m in spec["end_to_end"] if applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if applies(m, name)])


def config(name: str) -> dict:
    return _json(BENCH, "configs", f"{name}.json")


def traffic(name: str) -> dict:
    return _json(BENCH, "traffic", f"{name}.json")


def reference_solver(name: str):
    return importlib.import_module(f"gpubench.reference.{name}")


def metric_reader(name: str):
    return importlib.import_module(f"gpubench.metrics.{name}").read
