"""Segmentor input adapters: the port's own copies of ``Segmentor`` and
``LookUpSegmentor`` from ``geograypher_tpu/predictors/segmentors.py``
(numpy only).

A :class:`Segmentor` turns a camera's raw image into per-pixel prediction
data (one-hot class maps here), so the aggregation engine stays agnostic
to the prediction source.
"""

from __future__ import annotations

import typing
from pathlib import Path

import numpy as np

from geograypher_tpu_torch.constants import PATH_TYPE
from geograypher_tpu_torch.utils.io import read_image_or_numpy, resize_nearest


class Segmentor:
    """Abstract per-image predictor (reference segmentor.py:6-69)."""

    # does segment_image consume the raw pixels?  The segmentor camera
    # set skips the disk read + resize entirely when False (the
    # reference's dont_load_base_image=True default) — only pixel-driven
    # segmentors (brightness-style) set this True
    needs_image = False

    def __init__(self, num_classes: typing.Optional[int] = None):
        self.num_classes = num_classes

    def segment_image(
        self, image: np.ndarray, filename=None, image_scale: float = 1.0, **kwargs
    ) -> np.ndarray:
        raise NotImplementedError()

    def segment_images_batch(self, images, filenames=None, **kwargs):
        filenames = filenames or [None] * len(images)
        return [
            self.segment_image(im, filename=fn, **kwargs)
            for im, fn in zip(images, filenames)
        ]

    @staticmethod
    def inds_to_one_hot(
        inds: np.ndarray, num_classes: typing.Optional[int] = None
    ) -> np.ndarray:
        """Integer class map -> (H, W, C) float one-hot with NaN for
        out-of-range (reference segmentor.py:37-69)."""
        if num_classes is None:
            num_classes = int(np.nanmax(inds)) + 1
        inds = np.asarray(inds)
        one_hot = np.stack(
            [(inds == c).astype(float) for c in range(num_classes)], axis=-1
        )
        invalid = ~np.isfinite(inds) | (inds < 0) | (inds >= num_classes)
        one_hot[invalid] = np.nan
        return one_hot


class LookUpSegmentor(Segmentor):
    """Loads precomputed label images from a parallel folder tree
    (reference derived_segmentors.py:32-51) — the standard vehicle for
    'aggregate ML predictions onto the mesh'."""

    def __init__(self, base_folder: PATH_TYPE, lookup_folder: PATH_TYPE,
                 num_classes: int = 10):
        super().__init__(num_classes=num_classes)
        self.base_folder = Path(base_folder)
        self.lookup_folder = Path(lookup_folder)

    def segment_image(self, image, filename=None, image_scale: float = 1.0, **kw):
        try:
            rel = Path(filename).relative_to(self.base_folder)
        except ValueError:
            try:  # mixed absolute/relative bases resolve the same tree
                rel = (
                    Path(filename)
                    .resolve()
                    .relative_to(self.base_folder.resolve())
                )
            except ValueError:
                rel = Path(Path(filename).name)
        candidates = [
            self.lookup_folder / rel.with_suffix(suffix)
            for suffix in (".png", ".npy", ".tif", Path(filename).suffix)
        ]
        path = next((c for c in candidates if c.exists()), None)
        if path is None:
            raise FileNotFoundError(f"No label file for {filename}")
        labels = read_image_or_numpy(path)
        if labels.ndim == 3:
            labels = labels[..., 0]
        if image is not None:
            h, w = np.asarray(image).shape[:2]  # already at image_scale
        else:
            # no raw image on disk (or loading skipped): scale the label
            # raster itself so output resolution matches image_scale —
            # otherwise mixed-availability surveys return mixed shapes
            h = int(round(labels.shape[0] * image_scale))
            w = int(round(labels.shape[1] * image_scale))
        if labels.shape != (h, w):
            labels = resize_nearest(labels.astype(np.float32), w, h)
        return self.inds_to_one_hot(labels.astype(float), self.num_classes)
