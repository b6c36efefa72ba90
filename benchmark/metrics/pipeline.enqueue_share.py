"""Share of the surveys' wall time the main thread spent launching the
views' chains and their gated adds (span ``pipeline.enqueue``): sum of
``enqueue_s`` over sum of ``seconds`` of the window's ``pipeline_stats``
records; None where a record lacks the key (a program that does not time
it)."""


def read(window):
    total = sum(s["seconds"] for s in window.stats)
    if not total or any("enqueue_s" not in s for s in window.stats):
        return None
    return sum(s["enqueue_s"] for s in window.stats) / total
