"""Share of the window's views that overflowed their caps and were re-run:
sum of ``retried_views`` over sum of ``views`` of the window's
``pipeline_stats`` records."""


def read(window):
    views = sum(s["views"] for s in window.stats)
    return sum(s["retried_views"] for s in window.stats) / views if views else None
