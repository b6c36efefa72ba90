"""Device milliseconds of kernels per mask in the traced slice: the reading
of ``chain.device_ms_per_view`` (here the render chain, the lens remap,
the texture gather and the uint8 cast) over the slice's masks."""

from benchmark import cells

read = cells.reader("chain.device_ms_per_view")
