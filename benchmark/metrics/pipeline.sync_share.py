"""Share of the surveys' wall time the main thread spent fetching the
overflow flags and summing and downloading the accumulators (span
``pipeline.sync``): sum of ``sync_s`` over sum of ``seconds`` of the
window's ``pipeline_stats`` records; None where a record lacks the key (a
program that does not time it)."""


def read(window):
    total = sum(s["seconds"] for s in window.stats)
    if not total or any("sync_s" not in s for s in window.stats):
        return None
    return sum(s["sync_s"] for s in window.stats) / total
