"""Decorator camera set: images pass through a Segmentor.

Port of ``geograypher_tpu/cameras/segmentor_set.py`` on the port's
:class:`CameraSet`.  ``get_image_by_index`` returns the segmentor's
prediction (one-hot class maps, detection rasters, ...) instead of the
raw image.  A segmentor is any object with the interface of
:class:`geograypher_tpu_torch.predictors.segmentors.Segmentor`
(``segment_image`` and a ``needs_image`` flag).

:meth:`SegmentorCameraSet.get_subset_with_valid_segmentation` drops a view
only for what means "this view has no segmentation": a missing file
(``FileNotFoundError``, what a segmentor raises for a missing label file),
an image that does not decode (``ValueError``) and a label the segmentor
has no entry for (``KeyError``, ``IndexError``).  The JAX package catches
every ``Exception``; here a device error, or any other fault, propagates.
"""

from __future__ import annotations

from geograypher_tpu_torch.cameras.core import CameraSet


class SegmentorCameraSet(CameraSet):
    def __init__(self, base_camera_set: CameraSet, segmentor):
        self.base = base_camera_set
        self.segmentor = segmentor
        # share the base set's metadata (no copies)
        self.cam_to_world_transforms = base_camera_set.cam_to_world_transforms
        self.image_filenames = base_camera_set.image_filenames
        self.lon_lats = base_camera_set.lon_lats
        self.sensor_IDs = base_camera_set.sensor_IDs
        self.sensors = base_camera_set.sensors
        self.image_folder = base_camera_set.image_folder
        self.local_to_epsg_4978_transform = (
            base_camera_set.local_to_epsg_4978_transform
        )
        self._batch_cache = {}

    def get_subset_cameras(self, indices):
        return SegmentorCameraSet(
            self.base.get_subset_cameras(indices), self.segmentor
        )

    def get_image_by_index(self, index: int, image_scale: float = 1.0):
        """The segmented prediction for camera ``index``; only segmentors
        that read pixels pay the disk read."""
        fname = self.image_filenames[index]
        raw = None
        if (
            getattr(self.segmentor, "needs_image", False)
            and fname is not None
            and fname.exists()
        ):
            raw = self.base.get_image_by_index(index, image_scale)
        return self.segmentor.segment_image(
            raw, filename=fname, image_scale=image_scale, index=index
        )

    def n_image_channels(self) -> int:
        return self.segmentor.num_classes or 1

    #: what a view without a segmentation raises (see the module docstring)
    NO_SEGMENTATION = (FileNotFoundError, ValueError, KeyError, IndexError)

    def get_subset_with_valid_segmentation(self) -> "SegmentorCameraSet":
        """The cameras whose segmentation (at a quarter of the image
        size) succeeds."""
        ok = []
        for i in range(len(self)):
            try:
                self.get_image_by_index(i, image_scale=0.25)
            except self.NO_SEGMENTATION:
                continue
            ok.append(i)
        return self.get_subset_cameras(ok)
