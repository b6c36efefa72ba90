"""Milliseconds the prefetch workers spent loading a view (the provider,
the clip and the int8 cast; span ``pipeline.load`` on the workers'
threads): 1e3 times the sum of ``load_s`` over the sum of ``views`` of the
window's ``pipeline_stats`` records; None where a record lacks the key."""


def read(window):
    views = sum(s["views"] for s in window.stats)
    if not views or any("load_s" not in s for s in window.stats):
        return None
    return 1e3 * sum(s["load_s"] for s in window.stats) / views
