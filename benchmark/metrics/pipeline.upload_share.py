"""Share of the surveys' wall time the main thread spent inside the two-slot
pinned upload: sum of ``upload_s`` over sum of ``seconds`` of the window's
``pipeline_stats`` records."""


def read(window):
    total = sum(s["seconds"] for s in window.stats)
    return sum(s["upload_s"] for s in window.stats) / total if total else None
