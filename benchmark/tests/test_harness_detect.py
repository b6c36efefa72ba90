"""The detection cell through the harness at a small size on the CPU: a
sound run is correct and reports its rate and, traced, its per-layer
readings; the control (the plain reference in bfloat16 in the program's
place) and two faults fail ``correct``: every view's last box dropped by
the painter, and every seen face id shifted by one.  The readers of the
sparse path's record read None where the program logs none."""

import time

import pytest
import torch

from benchmark import cells, harness, scene
from benchmark.harness import Window

CELL = "tin1m-6k-treedet.detect-boxes"
detect = cells.plugin("entries", "detect")
RECORD_METRICS = ("detect.segment_share", "detect.remap_share", "detect.table_share",
                  "detect.download_share", "detect.csr_share",
                  "detect.table_gib_per_view", "detect.triples_per_view")


def small(views: int = 4, width: int = 768):
    """The cell at a test's size: a TIN of ~1,600 points, 768 x 512 frames
    (a 192 x 128 raster) at the focal lengths that keep the framing, 30
    crowns large enough for their boxes to overlap, a pool of 2 surveys."""
    cell = cells.load(CELL)
    c = cell.config
    c["mesh"] = dict(c["mesh"], n_points=1600)
    s = width / c["image"]["width"]
    c["image"] = {"width": width, "height": round(c["image"]["height"] * s)}
    c["sensors"] = [dict(x, f=x["f"] * s) for x in c["sensors"]]
    c["crowns"] = dict(c["crowns"], count=30, radius_m=[0.12, 0.22], spacing_m=0.12)
    cell.traffic = dict(cell.traffic, views_per_survey=views, survey_pool=2,
                        trace_seconds=0.2)
    return cell


def _run(cell, trace=False, seed=2**31 + 21):
    return harness.run(cell, seed, 0.3, trace, "cpu", time.perf_counter())


def test_a_sound_run_is_correct():
    out = _run(small())
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"agg_views_per_s", "setup_s"}
    assert out["metrics"]["agg_views_per_s"]["value"] > 0
    assert set(out["checks"]) == set(detect.LIMITS)


def test_a_traced_run_reads_the_sparse_path():
    out = _run(small(), trace=True)
    assert out["correct"], out["checks"]
    metrics = out["metrics"]
    for name in RECORD_METRICS:
        assert metrics[name]["value"] > 0, name
    shares = sum(metrics[n]["value"] for n in RECORD_METRICS if n.endswith("_share"))
    assert shares < 1.0
    assert metrics["device.idle_share.detect"]["value"] == 1.0  # no card, no device op


def _control(self, index):
    survey, tables = self.entry_of(index)
    done = scene.Done(index, survey, None)
    done.result = self.reference(done, torch.bfloat16)
    return done


class _LastBoxDropped(detect.TabularRectangleSegmentor):
    def _rows(self, filename):
        rows = super()._rows(filename)
        return rows[:-1] if rows is not None else None


def _face_shifted(self, cameras, index, **kwargs):
    p2f = _pix2face(self, cameras, index, **kwargs)
    return torch.where(p2f >= 0, (p2f + 1) % self.n_faces, p2f)


_pix2face = detect.TexturedMesh._pix2face_device


@pytest.mark.parametrize("fault", ["control_bfloat16", "last_box_dropped",
                                   "face_id_shifted"])
def test_a_broken_path_is_not_correct(monkeypatch, fault):
    if fault == "control_bfloat16":
        monkeypatch.setattr(detect.Entry, "run", _control)
    elif fault == "last_box_dropped":
        monkeypatch.setattr(detect, "TabularRectangleSegmentor", _LastBoxDropped)
    else:
        monkeypatch.setattr(detect.TexturedMesh, "_pix2face_device", _face_shifted)
    out = _run(small())
    assert not out["correct"], out["checks"]


def _window(stats=()):
    return Window(views=0, stats=list(stats), launches={}, peak_bytes=0, slice=None,
                  slice_views=0, slice_least_s=None)


@pytest.mark.parametrize("name", RECORD_METRICS)
def test_record_readers_on_synthetic_windows(name):
    read = cells.reader(name)
    key = name.split(".")[1].replace("_share", "_s")
    record = {"seconds": 4.0, "views": 200, "segment_s": 1.0, "remap_s": 0.5,
              "table_s": 2.0, "download_s": 0.25, "csr_s": 0.125,
              "table_bytes": 200 * 2**30, "triples": 2e7}
    records = [record, dict(record, seconds=4.0)]
    want = {"detect.table_gib_per_view": 1.0, "detect.triples_per_view": 1e5}
    assert read(_window(records)) == pytest.approx(want.get(name, record.get(key, 0) / 4.0))
    parent = [{k: v for k, v in record.items() if k in ("seconds", "views")}]
    assert read(_window(parent)) is None  # a program that logs no such key
    assert read(_window()) is None
