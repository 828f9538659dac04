"""The traced window: the benchmark's own spans around the operator
products, a ``torch.profiler`` trace of CPU and CUDA activity, and what the
per-layer metrics read from it.

The spans are the benchmark's: in a traced run each operator's product
methods are wrapped, on the operator objects the run built, in a profiler
range ``gpubench:<op>.<method>:<columns>``.  The program's own ranges
(``row_matmat``, ``wide_matmat``) open inside them.  A device activity
belongs to the span in which the host launched it (matched by the launch's
correlation id), so a product's device time holds everything its call put on
the card, whatever kernels carry it.

Recording every host operator slows the host's launches (a traced request
takes about twice as long), so the idle share is read from a second traced
stretch of requests that records CUDA activity alone (``DeviceTrace``).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from contextlib import contextmanager

from gpubench.lib import stats

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN = "gpubench:"
WINDOW = SPAN + "window"
PRODUCTS = ("matvec", "rmatvec", "matmat", "matmat_into", "rmatmat")

# The device work of the Krylov layer: a frozen copy of the first four
# kernel classes of ``scripts_torch/profile_solve.py``'s ``KINDS``, matched
# on the lower-cased activity name, first match wins.
KRYLOV_KINDS = (
    ("Cholesky", ("potrf", "getrf", "cholesky")),
    ("QR", ("geqrf", "orgqr", "ormqr", "householder")),
    ("triangular solves", ("trsm", "trsv", "triangular")),
    ("cuBLAS gemv/gemm/dot", ("gemv", "gemm", "dot_kernel", "dot")),
)


def krylov_kind(name: str):
    """The Krylov class of a device activity's name, or None."""
    low = name.lower()
    for k, keys in KRYLOV_KINDS:
        if any(key in low for key in keys):
            return k
    return None


def wrap_products(ops: dict):
    """Wrap each product method of each operator (``{"A": A_op, ...}``)
    on the object itself in a span that names the operator, the method and
    the number of columns.  Returns a function that takes the wrappers
    off."""
    import torch

    undo = []
    for op_name, op in ops.items():
        for method in PRODUCTS:
            if not hasattr(op, method):
                continue
            inner = getattr(op, method)

            def wrapped(X, *args, _inner=inner, _tag=f"{SPAN}{op_name}."
                        f"{method}:", **kw):
                cols = X.shape[1] if X.ndim == 2 else 1
                with torch.profiler.record_function(f"{_tag}{cols}"):
                    return _inner(X, *args, **kw)

            setattr(op, method, wrapped)
            undo.append((op, method))

    def remove():
        for op, method in undo:
            delattr(op, method)

    return remove


@contextmanager
def profiled(host=True):
    """Profile the block; its result holder gets the parsed trace as
    ``.trace``.  ``host``: CPU and CUDA activity, read as a ``Trace``;
    otherwise CUDA activity alone (nothing where there is no card), read
    as a ``DeviceTrace``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    holder = type("Traced", (), {})()
    acts = [ProfilerActivity.CPU] if host else []
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    if not acts:
        yield holder
        holder.trace = DeviceTrace([])
        return
    with profile(activities=acts) as prof:
        if host:
            with torch.profiler.record_function(WINDOW):
                yield holder
        else:
            yield holder
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    holder.trace = Trace(events) if host else DeviceTrace(events)


class DeviceTrace:
    """The device activity of a stretch traced without the host's
    operators.  Its window runs from the first CUDA API call (the first
    request's first launch) to the end of the last device activity (the
    last request's result); with no API call in the trace, from the first
    device activity.  Times in seconds."""

    def __init__(self, events):
        xs = [ev for ev in events if ev.get("ph") == "X"]
        self.device = [(ev["ts"] * 1e-6, (ev["ts"] + ev["dur"]) * 1e-6)
                       for ev in xs if ev.get("cat") in DEVICE_CATS]
        api = [ev["ts"] * 1e-6 for ev in xs
               if ev.get("cat") in ("cuda_runtime", "cuda_driver")]
        self.from_api = bool(api)
        if not self.device:
            self.t0 = self.t1 = self.window_s = self.busy_s = 0.0
            return
        self.t0 = min(api) if api else min(a for a, _ in self.device)
        self.t1 = max(b for _, b in self.device)
        self.window_s = self.t1 - self.t0
        self.busy_s = stats.union_length(
            stats.clipped(self.device, self.t0, self.t1))


class Trace:
    """What the metrics read of one traced window (times in seconds)."""

    def __init__(self, events):
        xs = [ev for ev in events if ev.get("ph") == "X"]
        win = [ev for ev in xs if ev.get("name") == WINDOW]
        if not win:
            raise ValueError("the trace holds no window range")
        self.t0 = win[0]["ts"] * 1e-6
        self.t1 = (win[0]["ts"] + win[0]["dur"]) * 1e-6
        self.window_s = self.t1 - self.t0
        launch = {ev["args"]["correlation"]: ev["ts"] * 1e-6 for ev in xs
                  if ev.get("cat") in ("cuda_runtime", "cuda_driver")
                  and "correlation" in ev.get("args", {})}
        spans = sorted((ev["ts"] * 1e-6, (ev["ts"] + ev["dur"]) * 1e-6,
                        ev["name"][len(SPAN):]) for ev in xs
                       if ev.get("cat") in ("user_annotation", "cpu_op")
                       and ev.get("name", "").startswith(SPAN)
                       and ev["name"] != WINDOW)
        self.spans = spans
        starts = [s[0] for s in spans]
        self.device = []   # (start, end, name, index of its span or None)
        for ev in xs:
            if ev.get("cat") not in DEVICE_CATS:
                continue
            t = launch.get(ev.get("args", {}).get("correlation"))
            span = None
            if t is not None:
                i = bisect.bisect_right(starts, t) - 1
                if i >= 0 and t <= spans[i][1]:
                    span = i
            t0 = ev["ts"] * 1e-6
            self.device.append((t0, t0 + ev["dur"] * 1e-6, ev["name"], span))
        self.host = sorted(
            (ev["ts"] * 1e-6, (ev["ts"] + ev["dur"]) * 1e-6, ev["name"])
            for ev in xs if ev.get("cat") in ("cpu_op", "user_annotation")
            and ev.get("name") != WINDOW)
        intervals = [(a, b) for a, b, _, _ in self.device]
        self.busy_s = stats.union_length(
            stats.clipped(intervals, self.t0, self.t1))

    def span_calls(self):
        """One entry per product call: (op, method, columns, device
        seconds of the activities launched inside its span)."""
        dev = [0.0] * len(self.spans)
        for a, b, _, i in self.device:
            if i is not None:
                dev[i] += b - a
        out = []
        for (_, _, label), sec in zip(self.spans, dev):
            op_method, cols = label.rsplit(":", 1)
            op, method = op_method.split(".", 1)
            out.append((op, method, int(cols), sec))
        return out

    def krylov_s(self):
        """Device seconds of the dense linear algebra outside the product
        spans: gemv, gemm and bmm, dots, Cholesky, QR, LU and the
        triangular solves."""
        return sum(b - a for a, b, name, i in self.device
                   if i is None and krylov_kind(name) is not None)

    def breakdown(self):
        """The device operations that took most time, and the longest idle
        gaps by the host operation that was running, ten of each."""
        ops = {}
        for a, b, name, _ in self.device:
            ops[name] = ops.get(name, 0.0) + (b - a)
        top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
        starts = [h[0] for h in self.host]
        idle = {}
        for g0, g1 in stats.gaps([(a, b) for a, b, _, _ in self.device],
                                 self.t0, self.t1):
            mid = 0.5 * (g0 + g1)
            i = bisect.bisect_right(starts, mid) - 1
            label = "no host operation"
            for j in range(i, max(i - 200, -1), -1):
                if self.host[j][1] >= mid:
                    label = self.host[j][2]
                    break
            idle[label] = idle.get(label, 0.0) + (g1 - g0)
        top_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        return dict(device_ops=[[k[:120], v] for k, v in top_ops],
                    idle_gaps=[[k[:120], v] for k, v in top_gaps])
