"""Device milliseconds of kernels per view in the traced slice: for each
kernel name its events' mean time times their number (their sum), added
over the names, over the slice's views.  Copies and fills are left out."""


def read(window):
    sl = window.slice
    if sl is None or not window.slice_views or not sl.kernels:
        return None
    return 1e3 * sum(s for _, s in sl.kernels.values()) / window.slice_views
