"""Share of the surveys' wall time inside ``aggregate_index_predictions``
spent downloading a view's triples and seen faces (span
``sparse.download``).
``detect.segment_share``'s reading for ``download_s``."""

from benchmark import cells


def read(window):
    return cells.plugin("metrics", "detect.segment_share").share(window, "download_s")
