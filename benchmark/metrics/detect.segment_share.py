"""Share of the surveys' wall time inside ``aggregate_index_predictions``
that the main thread spent in the segmentor's box painting (span
``sparse.segment``): sum of ``segment_s`` over sum of ``seconds`` of the
window's ``sparse_stats`` records; None where there is none or a record
lacks the key (a program that does not time it)."""


def share(window, key: str):
    """Sum of ``key`` over sum of ``seconds`` of the window's records, as
    above."""
    total = sum(s["seconds"] for s in window.stats)
    if not total or any(key not in s for s in window.stats):
        return None
    return sum(s[key] for s in window.stats) / total


def read(window):
    return share(window, "segment_s")
