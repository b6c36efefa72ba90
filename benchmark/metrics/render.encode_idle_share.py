"""Share of the traced slice in which the device sat idle while the mask
writer's main thread encoded a PNG: the idle-gap seconds the breakdown
names ``io.encode`` (0 where it names none) over the slice's wall time.
None where there is no slice, or where no gap is named by a span of the
mask writer (a program that opens none)."""

WRITER_SPANS = {"render.view", "render.overflow_read", "render.download",
                "io.encode", "io.write"}


def idle_share(window, span: str):
    """The share of the slice's idle gaps named ``span``, as above."""
    sl = window.slice
    if sl is None or not sl.window_s:
        return None
    gaps = dict(sl.idle_gaps)
    if not WRITER_SPANS & gaps.keys():
        return None
    return gaps.get(span, 0.0) / sl.window_s


def read(window):
    return idle_share(window, "io.encode")
