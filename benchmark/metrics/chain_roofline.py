"""The view chain's share of its roofline, in %: the least time of the
traced slice's views (``roofline.py``: the mesh, the labels and the
survey's accumulators over the HBM rate, or the candidate-pixel
operations over the float32 rate, whichever is larger) over the device
time of the slice's kernels."""


def read(window):
    sl = window.slice
    if sl is None or not sl.kernels or not window.slice_least_s:
        return None
    seconds = sum(s for _, s in sl.kernels.values())
    return 100.0 * window.slice_least_s / seconds
