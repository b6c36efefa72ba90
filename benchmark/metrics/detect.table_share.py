"""Share of the surveys' wall time inside ``aggregate_index_predictions``
spent in the dense table (span ``sparse.table``: the counts launch at
(F, n_local), ``nonzero`` over the table and the seen faces, each a wait
for the card).
``detect.segment_share``'s reading for ``table_s``."""

from benchmark import cells


def read(window):
    return cells.plugin("metrics", "detect.segment_share").share(window, "table_s")
