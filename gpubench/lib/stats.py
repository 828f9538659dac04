"""The arithmetic of the end-to-end and idle metrics, on host timestamps
and device intervals; pure functions."""

from __future__ import annotations

import numpy as np


def window_metrics(records, t_start: float, t_end: float) -> dict:
    """``records``: (t_sent, t_done, slices) of every request of the
    window, in seconds; the window runs from ``t_start`` to ``t_end`` (the
    last request's completion).  Returns the rate over all the window's
    work and time, and the 95th percentile of all request times."""
    if not records or t_end <= t_start:
        raise ValueError("an empty window")
    lat_ms = [(done - sent) * 1e3 for sent, done, _ in records]
    slices = sum(k for _, _, k in records)
    return dict(slices_per_s=slices / (t_end - t_start),
                request_ms_p95=float(np.percentile(lat_ms, 95)),
                requests=len(records), slices=slices,
                window_s=t_end - t_start)


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -np.inf
    for t0, t1 in sorted(intervals):
        if t1 <= end:
            continue
        total += t1 - max(t0, end)
        end = t1
    return total


def clipped(intervals, t0: float, t1: float):
    """The intervals cut to [t0, t1], empty ones dropped."""
    return [(max(a, t0), min(b, t1)) for a, b in intervals
            if min(b, t1) > max(a, t0)]


def idle_pct(intervals, t0: float, t1: float) -> float:
    """100 x (1 - the union of device intervals / the window)."""
    busy = union_length(clipped(intervals, t0, t1))
    return 100.0 * (1.0 - busy / (t1 - t0))


def gaps(intervals, t0: float, t1: float):
    """The idle gaps (start, end) of the window between device intervals."""
    out, end = [], t0
    for a, b in sorted(clipped(intervals, t0, t1)):
        if a > end:
            out.append((end, a))
        end = max(end, b)
    if t1 > end:
        out.append((end, t1))
    return out
