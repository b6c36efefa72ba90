"""Cells are found by name: a configuration, a traffic mix, an entry, a
label source, a mesh kind and a metric dropped into a copy as files, with
entries in BENCHMARK.json, make a cell with no edit to any file there."""

import json
import shutil

import numpy as np
import pytest

from conftest import ROOT, shrink

from benchmark import cells, harness, scene

NEW_MESH = '''"""A test's mesh kind: the grid's, shifted."""

from benchmark import cells


def make(shift, **grid):
    verts, faces = cells.plugin("meshes", "grid").make(**grid)
    return verts + shift, faces
'''

NEW_LABELS = '''"""A test's label source: the class images, through a provider."""

from benchmark import cells

CALLS = []


def prepare(pool, n_classes):
    CALLS.append("prepare")
    return cells.plugin("labels", "class_image").prepare(pool, n_classes)


def route(cameras, prepared, label_of):
    CALLS.append("route")
    return cells.plugin("labels", "class_image").route(cameras, prepared, label_of)
'''

NEW_ENTRY = '''"""A test's entry: aggregation with limits of its own."""

from benchmark import cells

_aggregate = cells.plugin("entries", "aggregate")
LIMITS = {"view_count_gap": 0.5, "fraction_gap": 0.5}
Entry = _aggregate.Entry
'''


def _copy(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return json.loads((tmp_path / "BENCHMARK.json").read_text())


def _write(tmp_path, rel, text):
    (tmp_path / "benchmark" / rel).write_text(text)


def test_new_files_make_a_cell(tmp_path):
    bench = _copy(tmp_path)
    config = json.loads((ROOT / "benchmark/configs/grid1m-4k.json").read_text())
    config["name"] = "grid2m-4k"
    config["mesh"]["n"] = 1001
    _write(tmp_path, "configs/grid2m-4k.json", json.dumps(config))
    traffic = json.loads((ROOT / "benchmark/traffic/agg-classimg.json").read_text())
    traffic["views_per_survey"] = 50
    traffic["raster"] = {"subtile": [8, 16]}
    _write(tmp_path, "traffic/agg-short.json", json.dumps(traffic))
    _write(tmp_path, "metrics/planner.views_per_survey.py",
           "def read(window):\n    return window.views / max(len(window.stats), 1)\n")
    bench["configs"].append({"name": "grid2m-4k", "source": "https://example.org/grid",
                             "file": "benchmark/configs/grid2m-4k.json", "reduced": []})
    bench["workloads"].append({"name": "grid2m-4k.agg-short", "config": "grid2m-4k",
                               "traffic": "agg-short", "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("grid2m-4k.agg-short")
    bench["per_layer"].append({"name": "planner.views_per_survey", "unit": "views",
                               "better": "higher", "source": "program_counter",
                               "layer": "census and plan", "moves": "agg_views_per_s",
                               "workloads": ["grid2m-4k.agg-short"]})
    # a metric with no workloads key: every cell that reports what it moves
    bench["per_layer"].append({"name": "device.idle_share.all", "unit": "fraction",
                               "better": "lower", "source": "device_trace",
                               "layer": "device", "moves": "agg_views_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = cells.load("grid2m-4k.agg-short", root=tmp_path)
    assert cell.config["mesh"]["n"] == 1001
    assert cell.traffic["views_per_survey"] == 50
    assert [m["name"] for m in cell.end_to_end] == ["agg_views_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["planner.views_per_survey",
                                                   "device.idle_share.all"]
    read = cells.reader("planner.views_per_survey", root=tmp_path)
    window = type("W", (), {"views": 100, "stats": [{}, {}]})()
    assert read(window) == 50
    # a name with no reader of its own takes its stem's
    assert (cells.reader("device.idle_share.all", root=tmp_path).__module__
            == cells.reader("device.idle_share.agg", root=tmp_path).__module__)
    # the cells already there still find theirs
    old = cells.load("grid1m-4k.agg-classimg", root=tmp_path)
    assert "planner.views_per_survey" not in [m["name"] for m in old.per_layer]
    assert "device.idle_share.all" in [m["name"] for m in old.per_layer]
    render = cells.load("tin1m-4k-brown.render-masks", root=tmp_path)
    assert "device.idle_share.all" not in [m["name"] for m in render.per_layer]


def test_new_code_is_new_files(tmp_path, monkeypatch):
    """A mix that needs an entry, a label source and a mesh kind of its own
    runs from new files alone."""
    bench = _copy(tmp_path)
    _write(tmp_path, "meshes/shifted_grid.py", NEW_MESH)
    _write(tmp_path, "labels/via_test.py", NEW_LABELS)
    _write(tmp_path, "entries/loose.py", NEW_ENTRY)
    config = json.loads((ROOT / "benchmark/configs/grid1m-4k.json").read_text())
    config["name"] = "shifted"
    config["mesh"] = dict(config["mesh"], kind="shifted_grid", shift=0.25)
    _write(tmp_path, "configs/shifted.json", json.dumps(config))
    traffic = json.loads((ROOT / "benchmark/traffic/agg-classimg.json").read_text())
    traffic.update(entry="loose", labels="via_test", rate_metric="loose_views_per_s")
    _write(tmp_path, "traffic/loose.json", json.dumps(traffic))
    bench["configs"].append({"name": "shifted", "source": "https://example.org/s",
                             "file": "benchmark/configs/shifted.json", "reduced": []})
    bench["workloads"].append({"name": "shifted.loose", "config": "shifted",
                               "traffic": "loose", "chips": 1, "why": "a test"})
    bench["end_to_end"].insert(0, {"name": "loose_views_per_s", "unit": "views/s",
                                   "better": "higher", "bound": 0.1,
                                   "source": "host_clock", "workloads": ["shifted.loose"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = shrink(cells.load("shifted.loose", root=tmp_path), views=3)
    module = cells.entry(cell.traffic, root=tmp_path)
    assert module.LIMITS == {"view_count_gap": 0.5, "fraction_gap": 0.5}
    # the plugins of the copy are the ones a run loads
    monkeypatch.setattr(cells, "plugin", _rooted(cells.plugin, tmp_path))
    verts, _ = scene.make_mesh(cell.config["mesh"])
    grid = {k: v for k, v in cell.config["mesh"].items() if k != "shift"}
    assert np.allclose(verts, scene.make_mesh(dict(grid, kind="grid"))[0] + 0.25)
    out = harness.run(cell, 2**31 + 5, 0.2, False, "cpu", 0.0)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"loose_views_per_s", "setup_s"}
    assert [c["limit"] for c in out["checks"].values()] == [0.5, 0.5]
    assert cells.plugin("labels", "via_test").CALLS[:2] == ["prepare", "route"]


def _rooted(plugin, root):
    """``plugin`` reading every module from ``root``."""
    def load(kind, name, _root=None):
        return plugin(kind, name, root)
    return load


def test_an_unknown_plugin_is_named():
    with pytest.raises(KeyError, match="no entries 'nowhere'"):
        cells.plugin("entries", "nowhere")


def test_every_named_file_exists():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = cells.load(w["name"])
        for m in cell.per_layer:
            assert callable(cells.reader(m["name"]))
        module = cells.entry(cell.traffic)
        assert callable(module.Entry) and module.LIMITS
        assert cell.traffic["rate_metric"] in {m["name"] for m in cell.end_to_end}
        assert cell.end_to_end and cell.per_layer
