"""Share of the surveys' wall time the main thread spent copying each
step's labels into the pinned staging buffer (span ``upload.stage``,
inside ``pipeline.upload``): sum of ``stage_s`` over sum of ``seconds`` of
the window's ``pipeline_stats`` records; None where a record lacks the key
(a program that does not time it)."""


def read(window):
    total = sum(s["seconds"] for s in window.stats)
    if not total or any("stage_s" not in s for s in window.stats):
        return None
    return sum(s["stage_s"] for s in window.stats) / total
