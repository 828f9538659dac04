#!/usr/bin/env python3
"""Where the time of one CT solve goes on the GPU: a torch.profiler trace.

    python3 scripts_torch/profile_solve.py

Builds the bench scenario of ``chip_smoke.py`` at n=64 and n=128 (int8 Morton
block-ELL operators, forward panels only, maxit=100) in seven modes — hybrid
BA-GMRES (lam=1e-2, fused residual) as the single-RHS solve and as the
serving batch of R=8 sinograms (noise seeds 0..7) with in-loop and with
deferred histories, the GKB family's ``lsqr`` and ``lsqr_batched`` R=8
(the redesigned K1 + K3, and K2 + K4, on the row-packed forms), and the
regularize-then-project solvers ``ba_rtp`` and ``ab_rtp`` (lam=1e-2, the
redesigned K1, and for AB-RTP one K2w of maxit columns a step) —
and times 5 solves of each after one warm-up, all before the first profiler
session (the profiler slows the host loop after it, too).  Then it runs one
solve per size and mode under ``torch.profiler`` (CPU and CUDA activities).
Prints one JSON line per size and mode with:

  * ``wall_ms``: the 5 solves without the profiler (CUDA events);
  * ``traced_ms``: host time of the profiled solve, synchronized;
  * ``busy_ms``: the union of all device intervals (kernels, copies,
    sets) in the trace, and ``busy_share`` = busy / traced;
  * ``launches``: device activities in the trace, and
    ``launches_per_iteration`` = launches / 100;
  * ``kinds``: device milliseconds and activity count by kind.  The
    multi-RHS products K2r/K4r/K2w are told apart by the profiler range
    their wrapper opens (``row_matmat`` / ``row_rmatmat`` /
    ``wide_matmat``): all device work launched inside it, the interleaving
    copy and K2w's split and finishing sum included, counts as the product
    (the window kernel, ``row_spmm_window_kernel``, counts as K2r/K4r);
  * ``wrapper_ranges``: per product, its wrapper's ranges in the trace and
    those that took no device activity (by their place in time order).

    python3 scripts_torch/profile_solve.py ab_rtp ba_rtp   # those modes only

Needs one CUDA card.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import sys
import tempfile
import time
from functools import partial

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (imports neither torch nor the port)

# first match wins; matched against the lower-cased activity name
KINDS = (
    ("K1 bucket_matvec", ("bucket_matvec",)),
    ("K2 bucket_matmat", ("bucket_matmat",)),
    ("K3/K4 finishing pass", ("bucket_rmat_finish",)),
    ("Cholesky", ("potrf", "getrf", "cholesky")),
    ("QR", ("geqrf", "orgqr", "ormqr", "householder")),
    ("triangular solves", ("trsm", "trsv", "triangular")),
    ("cuBLAS gemv/gemm/dot", ("gemv", "gemm", "dot_kernel", "dot")),
    ("norms", ("norm",)),
    ("reductions", ("reduce",)),
    ("elementwise (where/copy/fill/add)", ("elementwise", "fill", "copy",
                                           "where", "index", "cat")),
)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the profiler ranges of the multi-RHS wrappers (ops/spmv_cuda.py)
RANGES = {"row_matmat": "K2 row_matmat", "row_rmatmat": "K4 row_rmatmat",
          "wide_matmat": "K2w wide_matmat"}


class Ranges:
    """The wrappers' host ranges, and the host launch of each device
    activity (its runtime call, by correlation id): a device activity whose
    launch lies in a range belongs to that range's kind.  ``hits`` counts
    the activities each range took, so a range with none (a wrapper call
    whose launch the trace did not record) can be told apart."""

    def __init__(self, trace):
        spans = sorted((ev["ts"], ev["ts"] + ev["dur"], RANGES[ev["name"]])
                       for ev in trace if ev.get("ph") == "X"
                       and ev.get("cat") in ("user_annotation", "cpu_op")
                       and ev.get("name") in RANGES)
        self.starts = [t0 for t0, _, _ in spans]
        self.spans = spans
        self.launch_ts = {
            ev["args"]["correlation"]: ev["ts"] for ev in trace
            if ev.get("ph") == "X"
            and ev.get("cat") in ("cuda_runtime", "cuda_driver")
            and "correlation" in ev.get("args", {})}

        self.hits = [0] * len(spans)

    def kind(self, ev):
        ts = self.launch_ts.get(ev.get("args", {}).get("correlation"))
        i = bisect.bisect_right(self.starts, ts) - 1 if ts is not None else -1
        if i >= 0 and ts <= self.spans[i][1]:
            self.hits[i] += 1
            return self.spans[i][2]
        return None

    def empty(self):
        """Per kind: the ranges that took no device activity, as their
        places among that kind's ranges in time order, and the ranges."""
        out = {}
        for kind in set(RANGES.values()):
            places = [i for i, (_, _, k) in enumerate(self.spans)
                      if k == kind]
            out[kind] = dict(ranges=len(places), without_activity=[
                j for j, i in enumerate(places) if not self.hits[i]])
        return out


def kind_of(ev, ranges):
    kind = ranges.kind(ev)
    if kind is not None:
        return kind
    if ev.get("cat") in ("gpu_memcpy", "gpu_memset"):
        return "memcpy/memset"
    name = ev.get("name", "").lower()
    if "row_spmm_kernel" in name or "row_spmm_window_kernel" in name:
        return "row_spmm outside its wrapper's range"
    if "tile_spmm_kernel" in name or "split_kernel" in name:
        return "tile_spmm outside its wrapper's range"
    if "row_spmv_kernel" in name:
        # one template for both: the third argument is the gathered input
        # scale, on in K3's mode (the CT operators are int8, scaled)
        return ("K3 row_rmatvec" if re.search(
            r"row_spmv_kernel<[^,]+,[^,]+,\s*true", name) else "K1 row_matvec")
    if "bucket_rmat_kernel" in name:
        # one template for both: the last argument is the tile width
        return ("K3 bucket_rmatvec" if re.search(r",\s*1>", name)
                else "K4 bucket_rmatmat")
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def busy_union_us(intervals):
    total, end = 0.0, -np.inf
    for t0, t1 in sorted(intervals):
        if t1 <= end:
            continue
        total += t1 - max(t0, end)
        end = t1
    return total


def profile(n, mode, run, wall, info):
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    trace = trace.get("traceEvents", [])
    events = [ev for ev in trace
              if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATS]
    if not events:
        sys.exit(f"n={n} {mode}: the trace holds no device activity")
    ranges = Ranges(trace)
    kinds = {}
    for ev in events:
        kind = kind_of(ev, ranges)
        ms, cnt = kinds.get(kind, (0.0, 0))
        kinds[kind] = (ms + ev["dur"] / 1e3, cnt + 1)
    busy_ms = busy_union_us([(ev["ts"], ev["ts"] + ev["dur"])
                             for ev in events]) / 1e3
    print(json.dumps({
        "n": n, "mode": mode, "card": card(), "wall_ms_median": float(
            np.median(wall)), "wall_ms": wall, "traced_ms": traced_ms,
        "busy_ms": busy_ms, "busy_share": busy_ms / traced_ms,
        "launches": len(events),
        "launches_per_iteration": len(events) / chip_smoke.MAXIT,
        "kinds": {k: {"ms": ms, "count": c} for k, (ms, c) in sorted(
            kinds.items(), key=lambda kv: -kv[1][0])},
        "wrapper_ranges": ranges.empty(),
        "A_panel_mb": info["A_panel_mb"], "B_panel_mb": info["B_panel_mb"]}),
        flush=True)


def card():
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def gkb_run(name, P, b):
    fn, kw = chip_smoke.gkb_solver(name)
    return partial(fn, P.A_op, b, P.x_true, tol=0.0, maxit=chip_smoke.MAXIT,
                   **kw)


def rtp_run(name, P):
    return partial(chip_smoke.rtp_solver(name), P.A_op, P.B_op, P.b,
                   P.x_true, tol=0.0, maxit=chip_smoke.MAXIT,
                   lam=chip_smoke.LAM)


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_solve.py needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    only = set(sys.argv[1:])
    runs = []
    for n in (64, 128):
        P = chip_smoke.make_problem(n)
        b8 = torch.as_tensor(chip_smoke.noisy_sinograms(P, range(8)),
                             device="cuda")
        for mode, run in (
                ("single", partial(chip_smoke.solve, P)),
                ("batched R=8 in-loop",
                 partial(chip_smoke.solve_batched, P, b8, False)),
                ("batched R=8 deferred",
                 partial(chip_smoke.solve_batched, P, b8, True)),
                ("lsqr", gkb_run("lsqr", P, P.b)),
                ("lsqr_batched R=8", gkb_run("lsqr_batched", P, b8)),
                ("ba_rtp", rtp_run("ba_gmres_rtp", P)),
                ("ab_rtp", rtp_run("ab_gmres_rtp", P))):
            if only and mode not in only:
                continue
            runs.append((n, mode, run, chip_smoke.per_call_ms(run, reps=5),
                         P.info))
    for run in runs:
        profile(*run)


if __name__ == "__main__":
    main()
