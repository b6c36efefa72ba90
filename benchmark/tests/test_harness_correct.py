"""What decides ``correct``: a sound run passes; the control (the plain
reference in bfloat16 put in the program's place) and each fault an
aggregation cell can have, planted under a whole run, fail.

The faults: a survey that returns its accumulators unchanged; half of a
survey's views left out, the mean taken over the rest; an answer altered
where it is produced (the fractions' classes rolled by one).  A cell on
one chip has no exchange between chips to leave out.
"""

import json
import time

import numpy as np
import pytest
import torch

from conftest import ROOT, shrink

from benchmark import cells, harness
from benchmark.reference import raster as reference

CELLS = ("grid1m-4k.agg-classimg", "tin1m-4k-brown.agg-classimg")
aggregate = cells.plugin("entries", "aggregate")


def _run(cell, seed=2**31 + 11):
    return harness.run(cell, seed, 0.5, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(small_cell, name):
    out = _run(small_cell(name))
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["metrics"]["agg_views_per_s"]["value"] > 0


def test_the_onehot_mix_is_correct():
    """The one-hot mix, whose cell BENCHMARK.json leaves out for now (its
    rate spreads past any bound), still runs to a correct result."""
    config = json.loads((ROOT / "benchmark/configs/grid1m-4k.json").read_text())
    traffic = json.loads((ROOT / "benchmark/traffic/agg-onehot.json").read_text())
    e2e = [{"name": traffic["rate_metric"], "unit": "views/s"},
           {"name": "setup_s", "unit": "s"}]
    out = _run(shrink(cells.Cell("grid1m-4k.agg-onehot", 1, config, traffic, e2e, [])))
    assert out["correct"], out["checks"]
    assert out["metrics"]["onehot_views_per_s"]["value"] > 0


def _control(self, survey):
    """The control: the reference, in bfloat16, in the program's place,
    rows in the program's face order."""
    sums, counts = reference.aggregate(
        self.mesh_verts, self.mesh_faces, survey, self.config["sensors"], self.prepared,
        self.config["image"]["width"], self.config["image"]["height"],
        self.config["n_classes"], "cpu", torch.bfloat16)
    return sums[self.order], counts[self.order]


def _unchanged(self, survey):
    sums, counts = _sound(self, survey)
    return np.zeros_like(sums), np.zeros_like(counts)


def _half(self, survey):
    half = type(survey)(survey.c2w[::2], survey.sensor[::2], survey.label[::2])
    return _sound(self, half)


def _altered(self, survey):
    sums, counts = _sound(self, survey)
    return np.roll(sums, 1, axis=1), counts


_sound = aggregate.AggregateSystem.survey


@pytest.mark.parametrize("fault", [_control, _unchanged, _half, _altered],
                         ids=["control_bfloat16", "state_unchanged", "half_the_views",
                              "answer_altered"])
def test_a_broken_path_is_not_correct(small_cell, monkeypatch, fault):
    cell = small_cell(CELLS[0])
    keep = aggregate.AggregateSystem.__init__

    def init(self, verts, faces, *args, **kwargs):
        keep(self, verts, faces, *args, **kwargs)
        self.mesh_verts, self.mesh_faces = verts, faces

    monkeypatch.setattr(aggregate.AggregateSystem, "__init__", init)
    monkeypatch.setattr(aggregate.AggregateSystem, "survey", fault)
    out = _run(cell)
    assert not out["correct"], out["checks"]


def test_gaps_by_hand():
    ref = (np.array([[1.0, 0.0], [0.5, 0.5], [0.0, 0.0]]), np.array([1.0, 1.0, 0.0]))
    order = np.array([2, 0, 1])  # program row i is face order[i]
    program = (ref[0][order], ref[1][order])
    assert aggregate.gaps(program, ref, order) == {"view_count_gap": 0.0,
                                                  "fraction_gap": 0.0}
    moved = (program[0] + np.array([[0.0, 0.0], [0.0, 0.5], [0.0, 0.0]]), program[1])
    assert aggregate.gaps(moved, ref, order)["fraction_gap"] == 0.25
