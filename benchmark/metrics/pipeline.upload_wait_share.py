"""Share of the surveys' wall time the main thread blocked on a staging
slot's last copy before refilling it (span ``upload.wait``, inside
``pipeline.upload``): sum of ``upload_wait_s`` over sum of ``seconds`` of
the window's ``pipeline_stats`` records; None where a record lacks the
key."""


def read(window):
    total = sum(s["seconds"] for s in window.stats)
    if not total or any("upload_wait_s" not in s for s in window.stats):
        return None
    return sum(s["upload_wait_s"] for s in window.stats) / total
