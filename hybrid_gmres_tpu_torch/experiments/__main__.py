"""CLI runner for the eleven experiment drivers of the PyTorch port.

    python -m hybrid_gmres_tpu_torch.experiments --list
    python -m hybrid_gmres_tpu_torch.experiments all
    python -m hybrid_gmres_tpu_torch.experiments equivalence phantom2d_gpu
    python -m hybrid_gmres_tpu_torch.experiments --cpu equivalence

Runs on the card by default (each driver's default ``Config``: CUDA,
float32), and raises without one.  ``--cpu`` selects the reference's regime
instead: CPU, float64 (the MATLAB environment of e.g.
``analyze_regularization.m``); ``phantom2d_gpu`` keeps its operators' dtype
there.  Each driver writes its figures to ``--outdir`` (when matplotlib is
installed) and a scalar summary is merged into ``<outdir>/results.json``,
under the keys of the JAX package's file (``figures/results.json``, which
this CLI never writes: its default is ``figures_torch/``).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time

import numpy as np

# Canonical order = the JAX CLI's (SURVEY.md §2 rows 13-22), with its TPU
# driver's counterpart on the card last.
DRIVERS = [
    "equivalence",
    "ptr_rtp",
    "regularization",
    "gcv_surface_exp",
    "error_surface",
    "filter_factors_exp",
    "perturbation_bounds",
    "noise_sweep",
    "mismatch_sweep",
    "phantom2d",
    "phantom2d_gpu",
]

# results.json keys kept short and stable (the JAX CLI's).
_JSON_KEY = {
    "gcv_surface_exp": "gcv_surface",
    "filter_factors_exp": "filter_factors",
}


def _scalars(obj, prefix="", out=None, depth=0):
    """Numeric leaves of a result (dataclasses + dicts), arrays and configs
    skipped — enough for a regeneration log; oracle-grade numbers come from
    the per-driver extras below."""
    if out is None:
        out = {}
    if depth > 3:
        return out
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            if f.name in ("cfg", "prob"):
                continue
            _scalars(getattr(obj, f.name), f"{prefix}{f.name}_", out,
                     depth + 1)
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _scalars(v, f"{prefix}{k}_", out, depth + 1)
    elif isinstance(obj, (bool, str)) or obj is None:
        pass
    elif isinstance(obj, (int, float, np.integer, np.floating)):
        out[prefix.rstrip("_")] = float(obj)
    return out


def _last_finite(h):
    h = np.asarray(h, dtype=float)
    h = h[np.isfinite(h)]
    return float(h[-1]) if h.size else float("nan")


def _extras(name, mod, res):
    """Driver-specific oracle numbers (the JAX CLI's, by the same keys)."""
    if name == "equivalence":
        out = {}
        for a, b, _title in mod._PAIRS:
            xa, xb = res.solutions[a], res.solutions[b]
            out[f"{a}_vs_{b}_soldiff"] = float(
                np.linalg.norm(xa - xb) / max(np.linalg.norm(xb), 1e-300))
        return out
    if name == "ptr_rtp":
        return {k: _last_finite(h) for k, h in res.err_hists.items()}
    if name == "regularization":
        return {f"gcv_lambda_{k}": float(v)
                for k, v in res.gcv_lambdas.items()}
    if name == "error_surface":
        return {f"opt_{k}": [int(v[0]), float(v[1]), float(v[2])]
                for k, v in res.optima.items()}
    if name == "gcv_surface_exp":
        return {f"path_{k}_last": float(np.asarray(p)[-1])
                for k, p in res.paths.items()}
    if name in ("noise_sweep", "mismatch_sweep"):
        out = {}
        for k, e in res.final_errors.items():
            e = np.asarray(e, dtype=float)
            out[f"{k}_low"], out[f"{k}_high"] = float(e[0]), float(e[-1])
        return out
    if name == "phantom2d":
        return {k: _last_finite(h) for k, h in res.err_hists.items()}
    if name == "phantom2d_gpu":
        return {"backend": res.backend}
    return {}


def config(name, mod, cpu):
    """The driver's ``Config``: its defaults (on the card), or under
    ``cpu`` the reference regime, CPU and float64 (``phantom2d_gpu``: the
    CPU with its default operators)."""
    if not cpu:
        return mod.Config()
    if name == "phantom2d_gpu":
        return mod.Config(device="cpu")
    return mod.Config(device="cpu", dtype="float64")


def run_driver(name, outdir, cpu=False):
    mod = importlib.import_module(f"hybrid_gmres_tpu_torch.experiments.{name}")
    cfg = config(name, mod, cpu)
    t0 = time.time()
    if importlib.util.find_spec("matplotlib") is None:
        print(f"[{name}] matplotlib is not installed: no figures",
              file=sys.stderr)
        res, figs = mod.run(cfg), []
    else:
        res, figs = mod.main(outdir, cfg)
    dt = time.time() - t0
    summary = _scalars(res)
    summary.update(_extras(name, mod, res))
    summary["time_s"] = round(dt, 2)
    summary["figures"] = [os.path.basename(f) for f in figs]
    return summary


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m hybrid_gmres_tpu_torch.experiments",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("drivers", nargs="*",
                   help="driver names, or 'all' (default: all)")
    p.add_argument("--outdir", default="figures_torch")
    p.add_argument("--list", action="store_true", help="list drivers and exit")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU in float64, the reference's regime "
                        "(default: the card, float32)")
    args = p.parse_args(argv)

    if args.list:
        for d in DRIVERS:
            print(d)
        return 0

    names = args.drivers or ["all"]
    if names == ["all"]:
        names = list(DRIVERS)
        if args.cpu:
            # the card's driver joins 'all' on the card only, so that a
            # CPU run of 'all' keeps a card run's phantom2d_gpu entry
            # (naming it explicitly runs it on the CPU)
            names.remove("phantom2d_gpu")
            print("[skip] phantom2d_gpu (the card's scenario; kept out of "
                  "'all' under --cpu so the card run's results.json entry "
                  "survives)", file=sys.stderr)
    unknown = [n for n in names if n not in DRIVERS]
    if unknown:
        p.error(f"unknown driver(s) {unknown}; choices: {DRIVERS}")
    if not args.cpu:
        from hybrid_gmres_tpu_torch.utils.device import require_device

        require_device("cuda")

    os.makedirs(args.outdir, exist_ok=True)
    results_path = os.path.join(args.outdir, "results.json")
    results = {}
    # A full "all" run regenerates the file from scratch; a subset run
    # merges into the existing file but PRUNES keys no current driver
    # produces (stale keys must not survive).
    known = {_JSON_KEY.get(n, n) for n in DRIVERS}
    if os.path.exists(results_path) and set(names) != set(DRIVERS):
        with open(results_path) as f:
            results = {k: v for k, v in json.load(f).items() if k in known}

    for name in names:
        print(f"[{name}] running ...", file=sys.stderr)
        summary = run_driver(name, args.outdir, cpu=args.cpu)
        results[_JSON_KEY.get(name, name)] = summary
        with open(results_path, "w") as f:
            json.dump(results, f, indent=1, default=float)
        print(f"[{name}] done in {summary['time_s']}s", file=sys.stderr)

    print(f"wrote {results_path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
