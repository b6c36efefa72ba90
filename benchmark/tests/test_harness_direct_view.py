"""The reader of ``pipeline.direct_view_share`` on synthetic windows: the
views whose labels a prefetch worker wrote straight into a step slot, over
the views of the window's ``pipeline_stats`` records; None where a record
lacks ``direct_views`` (a program that stacks and stages on its main
thread) and where the window has no record."""

import pytest

from benchmark import cells
from benchmark.harness import Window


def _window(stats=()):
    return Window(views=0, stats=list(stats), launches={}, peak_bytes=0,
                  slice=None, slice_views=0, slice_least_s=None)


def test_direct_view_share():
    read = cells.reader("pipeline.direct_view_share")
    records = [{"seconds": 2.0, "views": 1000, "direct_views": 1000},
               {"seconds": 2.0, "views": 1000, "direct_views": 500}]
    assert read(_window(records)) == pytest.approx(0.75)
    assert read(_window([records[0], {"seconds": 2.0, "views": 1000}])) is None
    assert read(_window()) is None
