"""GiB of the dense (faces x local detections) int32 table a view: sum of
``table_bytes`` over sum of ``views`` of the window's ``sparse_stats``
records, over 2**30.  It is what a sparse count would not write; None
where there is no record or a record lacks the key."""


def read(window):
    views = sum(s.get("views", 0) for s in window.stats)
    if not views or any("table_bytes" not in s for s in window.stats):
        return None
    return sum(s["table_bytes"] for s in window.stats) / views / 2**30
