"""Share of the traced slice in which the device sat idle while the main
thread was in none of the program's operations or spans: the idle-gap
seconds the breakdown names by a span of the benchmark's own (``bench.*``)
or "host: outside any operation", over the slice's wall time.  The
breakdown keeps its ten longest names, so a short gap past them is not
counted."""

OUTSIDE = "host: outside any operation"


def read(window):
    sl = window.slice
    if sl is None or not sl.window_s:
        return None
    unnamed = sum(s for name, s in sl.idle_gaps
                  if name == OUTSIDE or name.startswith("bench."))
    return unnamed / sl.window_s
