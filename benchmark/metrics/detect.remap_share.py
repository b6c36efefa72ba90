"""Share of the surveys' wall time inside ``aggregate_index_predictions``
spent remapping a view's global ids to local ones (span
``sparse.remap``: ``unique`` and ``searchsorted`` on the card, and the wait
for the count of local ids).
``detect.segment_share``'s reading for ``remap_s``."""

from benchmark import cells


def read(window):
    return cells.plugin("metrics", "detect.segment_share").share(window, "remap_s")
