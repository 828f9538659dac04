"""The rate, tail and idle arithmetic on synthetic timestamps."""

import pytest

from gpubench.lib import stats


def _closed_loop(durations, start=100.0, slices=8):
    records, t = [], start
    for d in durations:
        records.append((t, t + d, slices))
        t += d
    return records, start, t


def test_rate_and_tail_of_a_steady_window():
    records, t0, t1 = _closed_loop([0.1] * 400)
    m = stats.window_metrics(records, t0, t1)
    assert m["slices_per_s"] == pytest.approx(80.0)
    assert m["request_ms_p95"] == pytest.approx(100.0)
    assert m["requests"] == 400 and m["slices"] == 3200


def test_a_stall_moves_both_rate_and_tail():
    steady, t0, t1 = _closed_loop([0.1] * 400)
    stalled, s0, s1 = _closed_loop([0.1] * 370 + [0.6] * 30)
    a = stats.window_metrics(steady, t0, t1)
    b = stats.window_metrics(stalled, s0, s1)
    assert b["slices_per_s"] < a["slices_per_s"] * 0.8
    assert b["request_ms_p95"] > a["request_ms_p95"] * 3


def test_failed_requests_add_time_but_no_slices():
    records, t0, t1 = _closed_loop([0.1] * 10)
    records[3] = (records[3][0], records[3][1], 0)
    assert stats.window_metrics(records, t0, t1)["slices"] == 72


def test_empty_window_is_an_error():
    with pytest.raises(ValueError):
        stats.window_metrics([], 0.0, 1.0)


def test_idle_share_and_a_stall():
    busy = [(i * 0.01, i * 0.01 + 0.008) for i in range(100)]   # 80% busy
    assert stats.idle_pct(busy, 0.0, 1.0) == pytest.approx(20.0, abs=0.3)
    stalled = busy[:50] + [(0.5 + 0.3 + (i - 50) * 0.01,
                            0.5 + 0.3 + (i - 50) * 0.01 + 0.008)
                           for i in range(50, 100)]
    assert stats.idle_pct(stalled, 0.0, 1.3) > 35.0


def test_union_counts_overlaps_once_and_clips():
    iv = [(0.0, 1.0), (0.5, 1.5), (3.0, 4.0)]
    assert stats.union_length(iv) == pytest.approx(2.5)
    assert stats.union_length(stats.clipped(iv, 0.5, 3.5)) == \
        pytest.approx(1.5)
    assert stats.gaps(iv, 0.0, 5.0) == [(1.5, 3.0), (4.0, 5.0)]


def _ev(cat, ts_us, dur_us, name="k"):
    return dict(ph="X", cat=cat, name=name, ts=ts_us, dur=dur_us)


def test_device_only_trace_window_starts_at_the_first_api_call():
    from gpubench.lib.tracing import DeviceTrace
    from gpubench.metrics import device_idle_pct

    # a launch at 0, kernels busy 0.4 s of 0.1-0.9 s, a memcpy ends at 1.0
    events = [_ev("cuda_runtime", 0, 5, "cudaLaunchKernel"),
              _ev("kernel", 100_000, 200_000), _ev("kernel", 200_000,
                                                   200_000),
              _ev("gpu_memcpy", 900_000, 100_000), _ev("cpu_op", -50, 10)]
    tr = DeviceTrace(events)
    assert tr.from_api
    assert tr.window_s == pytest.approx(1.0)
    assert tr.busy_s == pytest.approx(0.4)
    ctx = type("Ctx", (), dict(device_trace=tr))()
    assert device_idle_pct.read(ctx) == pytest.approx(60.0)
    # without API calls the window opens at the first device activity
    tr = DeviceTrace(events[1:])
    assert not tr.from_api and tr.window_s == pytest.approx(0.9)
    # nothing on the device: the reader stays silent
    ctx = type("Ctx", (), dict(device_trace=DeviceTrace([])))()
    assert device_idle_pct.read(ctx) is None
