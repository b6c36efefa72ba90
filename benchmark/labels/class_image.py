"""Int8 class images, handed to the survey pipeline one a view by a
``class_image_provider``."""

from torch.profiler import record_function


def prepare(pool, n_classes: int):
    """What the views hand over: the (n, H, W) int8 pool itself."""
    return pool


def route(cameras, prepared, label_of):
    """(cameras, class_image_provider) for a survey whose view k has the
    label image ``prepared[label_of[k]]``."""
    def provider(view):
        with record_function("bench.provider"):
            return prepared[label_of[view]]

    return cameras, provider
