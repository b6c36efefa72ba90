"""The sparse detection path's spans and its per-call record
(``meshes/sparse.py``): under a profiler every ``sparse.*`` span appears
on the main thread, once a view or once a call, and the ``sparse_stats``
record carries the call's seconds, spans and counters; with no profiler
no span enters ``record_function`` and the path makes no synchronise
call, and ``stats=`` keeps its per-view dicts."""

import json
import logging
import threading

import numpy as np
import pytest
import torch

from geograypher_tpu_torch.meshes import sparse
from geograypher_tpu_torch.utils import profiling
from tests.test_torch_detect_reference import PINHOLE, SCALE, _program, _survey
from tests.test_torch_metrics import spans_of
from tests.test_torch_rasterize import one_torch_thread  # noqa: F401

N_VIEWS = 3
PER_VIEW = tuple(f"sparse.{name}" for name in sparse.SPANS if name != "csr")
PER_CALL = ("sparse.csr", "sparse.argmax")
COUNTERS = ("seconds", "views", "local_classes", "table_bytes", "triples")


class Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.stats = []

    def emit(self, record):
        if hasattr(record, "sparse_stats"):
            self.stats.append(record.sparse_stats)


@pytest.fixture
def records():
    log = logging.getLogger(sparse.__name__)
    handler, level = Records(), log.level
    log.setLevel(logging.INFO)
    log.addHandler(handler)
    yield handler.stats
    log.removeHandler(handler)
    log.setLevel(level)


def _local_classes(folder, names) -> list:
    """Each view's detections painted at the aggregation scale."""
    from geograypher_tpu_torch.predictors.segmentors import TabularRectangleSegmentor

    seg = TabularRectangleSegmentor(folder, image_shape=(512, 768))
    out = []
    for name in names:
        img = seg.segment_image(None, filename=name, image_scale=SCALE)
        out.append(len(np.unique(img[np.isfinite(img)])))
    return out


def test_spans_and_the_record_under_a_profiler(tmp_path, records):
    inputs = _survey(tmp_path, "grid", 2**31 + 9, PINHOLE, views=N_VIEWS)
    with profiling.device_trace(tmp_path / "trace"):
        counts, seen, labels = _program(*inputs)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    spans = spans_of(events)
    for name in PER_VIEW:
        assert len(spans.get(name, [])) == N_VIEWS, name
    for name in PER_CALL:
        assert len(spans.get(name, [])) == 1, name
    threads = {t for name in PER_VIEW + PER_CALL for t, _, _ in spans[name]}
    assert threads == {threading.get_native_id()}

    (record,) = records
    assert set(COUNTERS) | {f"{name}_s" for name in sparse.SPANS} == set(record)
    n_local = _local_classes(inputs[3], inputs[4])
    n_faces = len(inputs[1])
    assert record["views"] == N_VIEWS and record["local_classes"] == sum(n_local)
    assert record["table_bytes"] == n_faces * sum(n_local) * 4
    assert record["triples"] == counts.nnz > 0
    assert sum(record[f"{name}_s"] for name in sparse.SPANS) <= record["seconds"]
    for name in sparse.SPANS:  # a span's total is its trace events' length
        traced = sum(e - s for _, s, e in spans[f"sparse.{name}"]) / 1e6
        assert record[f"{name}_s"] == pytest.approx(traced, rel=0.2, abs=2e-3), name


def test_no_span_and_no_synchronise_without_a_profiler(tmp_path, records, monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    synchronised = []
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: synchronised.append(a))
    assert not profiling.profiler_recording()
    inputs = _survey(tmp_path, "grid", 2**31 + 9, PINHOLE, views=N_VIEWS)
    counts, _, labels = _program(*inputs)
    assert counts.nnz > 0 and np.isfinite(labels).any()
    assert synchronised == []
    (record,) = records
    assert record["views"] == N_VIEWS and record["triples"] == counts.nnz


def test_the_stats_list_keeps_its_per_view_seconds(tmp_path, records):
    stats = []
    _program(*_survey(tmp_path, "grid", 2**31 + 9, PINHOLE, views=N_VIEWS), stats=stats)
    keys = {"segment_s", "upload_s", "remap_s", "pix2face_s", "counts_s", "nonzero_s",
            "download_s", "host_s"}
    assert len(stats) == N_VIEWS and all(set(s) == keys for s in stats)
    assert len(records) == 1
