"""Share of the traced slice in which no operation ran on the device: one
minus the union of every device interval (kernels, copies, fills) over the
slice's wall time."""


def read(window):
    sl = window.slice
    if sl is None or not sl.window_s:
        return None
    return 1.0 - sl.busy_s / sl.window_s
