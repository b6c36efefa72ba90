"""Peak device memory of the window, GiB: ``torch.cuda.max_memory_allocated``
after a reset at the window's start."""


def read(window):
    return window.peak_bytes / 2**30 if window.peak_bytes else None
