"""Share of the surveys' wall time the pipeline's main thread waited on the
prefetch workers: sum of ``fetch_wait_s`` over sum of ``seconds`` of the
window's ``pipeline_stats`` records."""


def read(window):
    total = sum(s["seconds"] for s in window.stats)
    return sum(s["fetch_wait_s"] for s in window.stats) / total if total else None
