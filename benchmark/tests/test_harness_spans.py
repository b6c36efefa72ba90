"""The readers of the program's spans and of the idle time they name, on
synthetic windows: the survey pipeline's host times from its
``pipeline_stats`` records, the mask writer's idle gaps, and the idle time
no span of the program names.  A window without the key or without a
slice reads None."""

import pytest

from benchmark import cells
from benchmark.harness import Window
from benchmark.trace import Slice, reduce_events

PIPELINE = {  # reader: the key it adds up over the records' seconds
    "pipeline.stack_share": "stack_s",
    "pipeline.stage_share": "stage_s",
    "pipeline.upload_wait_share": "upload_wait_s",
    "pipeline.enqueue_share": "enqueue_s",
    "pipeline.sync_share": "sync_s",
}
OUTSIDE = "host: outside any operation"


def _window(stats=(), slice_=None, views=0):
    return Window(views=views, stats=list(stats), launches={}, peak_bytes=0,
                  slice=slice_, slice_views=0, slice_least_s=None)


def _slice(gaps, window_s=10.0):
    return Slice(window_s=window_s, busy_s=window_s - sum(s for _, s in gaps),
                 kernels={}, device_ops=[], idle_gaps=[list(g) for g in gaps])


def _x(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}


@pytest.mark.parametrize("metric,key", sorted(PIPELINE.items()))
def test_pipeline_shares(metric, key):
    read = cells.reader(metric)
    records = [{"seconds": 3.0, "views": 8, key: 0.5},
               {"seconds": 1.0, "views": 8, key: 0.5}]
    assert read(_window(records)) == pytest.approx(0.25)
    parent = [dict(records[0]), {"seconds": 1.0, "views": 8}]  # lacks the key
    assert read(_window(parent)) is None
    assert read(_window()) is None


def test_load_ms_per_view():
    read = cells.reader("pipeline.load_ms_per_view")
    records = [{"seconds": 2.0, "views": 1000, "load_s": 3.0},
               {"seconds": 2.0, "views": 1000, "load_s": 5.0}]
    assert read(_window(records)) == pytest.approx(4.0)
    assert read(_window([{"seconds": 2.0, "views": 1000}])) is None
    assert read(_window()) is None


def test_mask_writer_idle_shares():
    encode = cells.reader("render.encode_idle_share")
    write = cells.reader("render.write_idle_share")
    traced = _window(slice_=_slice([("io.encode", 6.0), ("render.download", 0.5),
                                    ("bench.save_renders", 0.2)]))
    assert encode(traced) == pytest.approx(0.6)
    assert write(traced) == 0.0  # the writer's spans are there, no write gap
    traced.slice.idle_gaps.append(["io.write", 0.3])
    assert write(traced) == pytest.approx(0.03)
    parent = _window(slice_=_slice([("bench.save_renders", 7.0), (OUTSIDE, 0.1)]))
    for read in (encode, write):
        assert read(parent) is None  # a program that opens no span
        assert read(_window()) is None  # an untraced run


def test_idle_unnamed_share_counts_bench_spans_and_outside():
    read = cells.reader("device.idle_unnamed_share.agg")
    assert read is cells.reader("device.idle_unnamed_share.render")
    sl = _slice([("pipeline.stack", 3.0), ("bench.survey", 0.4), (OUTSIDE, 0.1),
                 ("aten::copy_", 1.0), ("benchmark", 2.0)])
    assert read(_window(slice_=sl)) == pytest.approx(0.05)
    assert read(_window()) is None


def test_program_spans_name_the_gaps_inside_the_benchmarks():
    """Idle gaps inside ``bench.survey`` take the innermost program span
    that covers their middle; a gap under no program span keeps the
    benchmark's name, one under no span at all is outside any operation;
    only those two count as unnamed."""
    events = [
        _x("bench.slice", "user_annotation", 0, 200),
        _x("bench.survey", "user_annotation", 0, 180),
        _x("pipeline.prepare", "user_annotation", 0, 10),
        _x("pipeline.fetch_wait", "user_annotation", 20, 60),
        _x("pipeline.stack", "user_annotation", 50, 30),
        _x("pipeline.load", "user_annotation", 0, 180, tid=2),  # a worker
        _x("pipeline.upload", "user_annotation", 80, 20),
        _x("upload.stage", "user_annotation", 80, 15),
        _x("pipeline.enqueue", "user_annotation", 100, 40),
        _x("raster", "kernel", 10, 10, tid=7),
        _x("Memcpy HtoD", "gpu_memcpy", 95, 5, tid=9),
        _x("raster", "kernel", 100, 50, tid=7),
        _x("Memset", "gpu_memset", 180, 5, tid=9),
    ]
    sl = reduce_events(events)
    gaps = dict(sl.idle_gaps)
    # gaps: 0-10 (prepare), 20-95 (mid 57.5: stack inside fetch_wait),
    # 150-180 (mid 165: the survey, under no program span), 185-200 (none)
    assert gaps == {"pipeline.prepare": pytest.approx(10e-6),
                    "pipeline.stack": pytest.approx(75e-6),
                    "bench.survey": pytest.approx(30e-6),
                    OUTSIDE: pytest.approx(15e-6)}
    read = cells.reader("device.idle_unnamed_share.agg")
    assert read(_window(slice_=sl)) == pytest.approx(45 / 200)
