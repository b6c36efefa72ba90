"""Share of the traced slice in which the device sat idle while the mask
writer's main thread waited for its pool of writer threads to finish
files: ``render.encode_idle_share``'s reading for the gaps named
``render.writer_wait``.  Near 0 where the main thread sets the pace; a
large share says the pool's encodes set it.  None where
``render.encode_idle_share`` reads None, and where the main thread
encodes itself (gaps named ``io.encode``: a program with no writer pool
to wait for)."""

from benchmark import cells


def read(window):
    helper = cells.plugin("metrics", "render.encode_idle_share")
    if helper.idle_share(window, "io.encode"):
        return None
    return helper.idle_share(window, "render.writer_wait")
