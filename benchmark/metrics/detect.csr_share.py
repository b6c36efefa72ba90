"""Share of the surveys' wall time inside ``aggregate_index_predictions``
spent building the survey's CSR on the host (span ``sparse.csr``).
``detect.segment_share``'s reading for ``csr_s``."""

from benchmark import cells


def read(window):
    return cells.plugin("metrics", "detect.segment_share").share(window, "csr_s")
