"""(H, W, C) float32 one-hot stacks, handed over by a segmentor; the
survey pipeline's default provider turns them into class images."""

import numpy as np
from torch.profiler import record_function

from geograypher_tpu_torch.cameras.segmentor_set import SegmentorCameraSet


class _Segmentor:
    """A segmentor that hands over the one-hot stack of a view's labels."""

    needs_image = False

    def __init__(self, stacks, label_of):
        self.stacks, self.label_of = stacks, label_of
        self.num_classes = stacks[0].shape[-1]

    def segment_image(self, image, filename=None, image_scale=1.0, index=None, **kw):
        with record_function("bench.segmentor"):
            return self.stacks[self.label_of[index]]


def prepare(pool, n_classes: int):
    """The one-hot stack of each label image of the pool."""
    eye = np.eye(n_classes, dtype=np.float32)
    return [eye[lab] for lab in pool]


def route(cameras, prepared, label_of):
    """(cameras behind the segmentor, no provider): the pipeline's
    default provider reads the segmentor's stacks."""
    return SegmentorCameraSet(cameras, _Segmentor(prepared, label_of)), None
