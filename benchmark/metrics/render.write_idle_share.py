"""Share of the traced slice in which the device sat idle while the mask
writer's main thread wrote a file: ``render.encode_idle_share``'s reading
for the gaps named ``io.write``."""

from benchmark import cells


def read(window):
    return cells.plugin("metrics", "render.encode_idle_share").idle_share(
        window, "io.write")
