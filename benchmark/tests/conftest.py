"""Shared pieces of the harness's CPU tests: the repository root on the
path, and a cell cut to a size a CPU test run holds."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def shrink(cell, views: int = 6):
    """``cell`` at a test's size: a 40 x 40-vertex grid or a TIN of ~1,600
    points, 192 x 108 images at the focal lengths that keep the views'
    framing, ``views`` views a survey, 8-pixel label squares."""
    c = cell.config
    mesh = dict(c["mesh"])
    mesh.update({"n": 40} if "n" in mesh else {"n_points": 1600})
    c["mesh"] = mesh
    scale = 192 / c["image"]["width"]
    c["image"] = {"width": 192, "height": 108}
    c["sensors"] = [dict(s, f=s["f"] * scale) for s in c["sensors"]]
    c["views_per_survey"] = views
    cell.traffic = dict(cell.traffic, label_patch=8, trace_seconds=0.2)
    cell.traffic.pop("views_per_survey", None)
    return cell


@pytest.fixture
def small_cell():
    """A loader of cells at a test's size."""
    from benchmark import cells

    return lambda name: shrink(cells.load(name))
