"""The reader of ``render.writer_wait_share`` on synthetic windows: the
idle gaps named ``render.writer_wait`` over the slice; 0 where the mask
writer's spans name gaps and this one does not; None where the slice has
none of them, where the main thread encodes (a program with no writer
pool), and without a slice."""

import pytest

from benchmark import cells
from benchmark.harness import Window
from benchmark.trace import Slice, reduce_events

OUTSIDE = "host: outside any operation"


def _window(gaps=None, window_s=10.0, slice_=None):
    if gaps is not None:
        slice_ = Slice(window_s=window_s, busy_s=window_s - sum(s for _, s in gaps),
                       kernels={}, device_ops=[], idle_gaps=[list(g) for g in gaps])
    return Window(views=0, stats=[], launches={}, peak_bytes=0, slice=slice_,
                  slice_views=0, slice_least_s=None)


def test_reads_the_writer_wait_gaps():
    read = cells.reader("render.writer_wait_share")
    pooled = _window([("render.writer_wait", 1.5), ("render.download", 0.5),
                      ("render.view", 0.2), ("bench.save_renders", 0.1)])
    assert read(pooled) == pytest.approx(0.15)
    assert read(_window([("render.view", 0.4), ("render.download", 0.5),
                         (OUTSIDE, 0.1)])) == 0.0  # the writer's spans, no wait


def test_none_without_the_writer_pool_or_a_slice():
    read = cells.reader("render.writer_wait_share")
    main_thread_encodes = _window([("io.encode", 6.0), ("render.download", 0.5)])
    assert read(main_thread_encodes) is None
    assert read(_window([("bench.save_renders", 7.0), (OUTSIDE, 0.1)])) is None
    assert read(_window()) is None


def _x(name, ts, dur, tid=1, cat="user_annotation"):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}


def test_worker_threads_name_no_gap():
    """The writer threads' encodes and writes leave the gaps to the main
    thread's spans: the drain's wait names the gap under it."""
    events = [
        _x("bench.slice", 0, 100),
        _x("bench.save_renders", 0, 100),
        _x("render.view", 0, 20),
        _x("render.download", 20, 10),
        _x("render.writer_wait", 40, 60),
        _x("io.encode", 25, 70, tid=2),
        _x("io.write", 95, 5, tid=2),
        _x("raster", 5, 10, tid=7, cat="kernel"),
        _x("Memcpy DtoH", 20, 10, tid=7, cat="gpu_memcpy"),
    ]
    sl = reduce_events(events)
    # gaps: 0-5 (view), 15-20 (view), 30-100 (mid 65: the drain's wait)
    assert dict(sl.idle_gaps) == {"render.view": pytest.approx(10e-6),
                                  "render.writer_wait": pytest.approx(70e-6)}
    assert cells.reader("render.writer_wait_share")(_window(slice_=sl)) == (
        pytest.approx(0.7))
    assert cells.reader("render.encode_idle_share")(_window(slice_=sl)) == 0.0
