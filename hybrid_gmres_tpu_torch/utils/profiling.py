"""Tracing and timing utilities (PyTorch port of
``hybrid_gmres_tpu/utils/profiling.py``).

A ``torch.profiler`` trace context for the device timeline, a wall-clock
benchmark helper that waits for the card, a device timer on CUDA events, the
nnz/s throughput calculator, and the dispatch floor of one call.

Each timer times the device of the tensors the callable returns: CUDA events
and ``torch.cuda.synchronize`` for CUDA tensors, ``time.perf_counter`` for
CPU tensors, which the caller chose.  Nothing falls back to timing the CPU
when the work was queued on the card.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch

from hybrid_gmres_tpu_torch.utils.device import require_device


def _tensors(obj, depth=0):
    """The tensors of a result: a tensor, or one inside (named) tuples,
    lists, dicts and dataclasses, a few levels deep."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif depth > 3 or obj is None or isinstance(obj, (str, bytes)):
        return
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v, depth + 1)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _tensors(v, depth + 1)
    elif hasattr(obj, "__dataclass_fields__"):
        for name in obj.__dataclass_fields__:
            yield from _tensors(getattr(obj, name), depth + 1)


def result_device(out) -> torch.device:
    """The device whose work produced ``out``: CUDA if any tensor of it lies
    on the card, else the CPU.  Raises when ``out`` holds no tensor: a timer
    cannot tell what to wait for (return the result from the callable)."""
    devices = {t.device for t in _tensors(out)}
    if not devices:
        raise ValueError(
            "the timed callable returned no tensor, so its device is "
            "unknown: return its result (or pass device=)")
    cuda = sorted((d for d in devices if d.type == "cuda"), key=str)
    return cuda[0] if cuda else torch.device("cpu")


def _wait(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def device_trace(logdir: str, device="cuda"):
    """Trace the block with ``torch.profiler`` (CPU and, on the card, CUDA
    activities) and write a Chrome trace to ``logdir/trace.json`` (open it
    in Perfetto or ``chrome://tracing``).  Yields the profiler, whose
    ``key_averages()`` tables the trace.  ``device="cpu"`` traces the CPU
    only; ``"cuda"`` without a card raises."""
    from torch.profiler import ProfilerActivity, profile

    dev = require_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _wait(dev)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def benchmark(fn: Callable, *args, iters: int = 3, warmup: int = 1,
              **kwargs) -> dict:
    """Best/mean wall time of ``fn(*args, **kwargs)``, each call waited for
    on the device of its result (``torch.cuda.synchronize`` for CUDA
    tensors).  With ``warmup=0`` the first timed call starts at once: the
    caller has waited for its earlier work."""
    device = None
    for _ in range(warmup):
        device = result_device(fn(*args, **kwargs))
        _wait(device)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if device is None:
            device = result_device(out)
        _wait(device)
        times.append(time.perf_counter() - t0)
    return {
        "best_s": min(times),
        "mean_s": sum(times) / len(times),
        "times": times,
    }


def spmv_throughput(nnz: int, seconds: float, dtype_bytes: int = 4) -> dict:
    """nnz/s and effective GB/s for one sparse matvec."""
    return {
        "nnz_per_s": nnz / seconds,
        "gb_per_s": nnz * (dtype_bytes + 4) / seconds / 1e9,  # value + index
    }


def device_seconds(fn: Callable, *args, repeats: int = 10,
                   device=None) -> float:
    """Mean device seconds of one ``fn(*args)`` over ``repeats`` back-to-back
    calls, after three warm-up calls.

    On the card: the calls run between two CUDA events.  A kernel of a few
    microseconds launches from Python more slowly than it runs, so a spin of
    the card (``torch.cuda._sleep``) is queued first, long enough for the
    host to queue every call behind it: the calls then run back to back and
    the events time the device, not the host's launches.  On the CPU (the
    caller's choice): ``time.perf_counter`` around the calls.

    ``device``: where the work runs; by default the device of the tensors
    ``fn`` returns (a callable that returns nothing needs it)."""
    for _ in range(3):
        out = fn(*args)
    dev = result_device(out) if device is None else require_device(device)
    _wait(dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(repeats):
            fn(*args)
        return (time.perf_counter() - t0) / repeats
    with torch.cuda.device(dev):
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        # twice the host's time for the calls, in cycles at up to 2 GHz
        torch.cuda._sleep(int(min(2 * repeats * host_s, 2.0) * 2e9))
        start.record()
        for _ in range(repeats):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3 / repeats


def dispatch_floor_seconds(repeats: int = 5, device="cuda") -> float:
    """The fixed cost of one call and its read-back: the least wall time,
    over ``repeats`` calls, of a bare ``x + 1`` on ``device`` with the
    result read back on the host (``.item()``).  Printed beside a wall
    time, it splits the wall into dispatch and device work.  ``device``:
    the card by default (raises without one), or ``"cpu"``."""
    dev = require_device(device)
    x = torch.zeros((), dtype=torch.float32, device=dev)
    (x + 1).item()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        (x + 1).item()
        times.append(time.perf_counter() - t0)
    return min(times)
