"""Share of the surveys' wall time the pipeline's main thread spent
stacking a step's class images (span ``pipeline.stack``, inside
``pipeline.fetch_wait``): sum of ``stack_s`` over sum of ``seconds`` of the
window's ``pipeline_stats`` records; None where a record lacks the key (a
program that does not time it)."""


def read(window):
    total = sum(s["seconds"] for s in window.stats)
    if not total or any("stack_s" not in s for s in window.stats):
        return None
    return sum(s["stack_s"] for s in window.stats) / total
