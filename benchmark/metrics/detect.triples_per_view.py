"""(face, detection, count) triples downloaded a view: sum of ``triples``
over sum of ``views`` of the window's ``sparse_stats`` records; None where
there is no record or a record lacks the key."""


def read(window):
    views = sum(s.get("views", 0) for s in window.stats)
    if not views or any("triples" not in s for s in window.stats):
        return None
    return sum(s["triples"] for s in window.stats) / views
