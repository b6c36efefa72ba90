"""The reduction of a trace on a synthetic one: the union of device
intervals, kernels by name, and idle gaps named by the host."""

import pytest

from benchmark.trace import merge, reduce_events


def _x(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}


def test_merge():
    assert merge([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]


def test_union_idle_share_and_gaps():
    events = [
        _x("bench.slice", "user_annotation", 0, 100),
        _x("bench.survey", "user_annotation", 0, 100),
        _x("aten::copy_", "cpu_op", 40, 20),
        _x("other thread", "cpu_op", 0, 100, tid=2),
        # two streams overlapping: 10-30 and 20-35 are busy 10-35 once
        _x("raster", "kernel", 10, 20, tid=7),
        _x("counts", "kernel", 20, 15, tid=8),
        _x("raster", "kernel", 60, 10, tid=7),
        _x("Memcpy HtoD", "gpu_memcpy", 90, 20, tid=9),  # clipped at 100
        _x("before", "kernel", -50, 10, tid=7),  # outside the slice
    ]
    sl = reduce_events(events)
    assert sl.window_s == pytest.approx(100e-6)
    assert sl.busy_s == pytest.approx((25 + 10 + 10) * 1e-6)
    assert 1 - sl.busy_s / sl.window_s == pytest.approx(0.55)
    assert sl.kernels == {"raster": (2, pytest.approx(30e-6)),
                          "counts": (1, pytest.approx(15e-6))}
    # gaps: 0-10 (survey), 35-60 (mid 47.5 in copy_), 70-90 (survey)
    gaps = dict(sl.idle_gaps)
    assert gaps["bench.survey"] == pytest.approx(30e-6)
    assert gaps["aten::copy_"] == pytest.approx(25e-6)
    assert "other thread" not in gaps
    assert sl.device_ops[0] == ["raster", pytest.approx(30e-6)]


def test_per_event_means_times_counts():
    events = [_x("bench.slice", "user_annotation", 0, 1000)]
    events += [_x("k", "kernel", 10 * i, 4) for i in range(50)]
    sl = reduce_events(events)
    n, seconds = sl.kernels["k"]
    assert n == 50 and seconds / n == pytest.approx(4e-6)


def test_a_trace_without_its_slice_is_refused():
    with pytest.raises(ValueError):
        reduce_events([_x("k", "kernel", 0, 1)])
