"""Share of the surveys' views whose class image a prefetch worker wrote
straight into its row of a step slot, so that the main thread neither
stacked nor staged it (counter ``direct_views``): sum of ``direct_views``
over sum of ``views`` of the window's ``pipeline_stats`` records; None
where a record lacks the key (a program that does not count them)."""


def read(window):
    views = sum(s["views"] for s in window.stats)
    if not views or any("direct_views" not in s for s in window.stats):
        return None
    return sum(s["direct_views"] for s in window.stats) / views
