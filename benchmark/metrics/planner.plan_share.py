"""Share of the surveys' wall time spent planning (census and buckets): sum
of ``plan_s`` over sum of ``seconds`` of the window's ``pipeline_stats``
records."""


def read(window):
    total = sum(s["seconds"] for s in window.stats)
    return sum(s["plan_s"] for s in window.stats) / total if total else None
