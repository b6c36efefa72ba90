"""Decorator camera set: images pass through a Segmentor.

Port of ``geograypher_tpu/cameras/segmentor_set.py`` on the port's
:class:`CameraSet`.  ``get_image_by_index`` returns the segmentor's
prediction (one-hot class maps, detection rasters, ...) instead of the
raw image.  A segmentor is any object with the interface of the JAX
package's framework-free ``geograypher_tpu.predictors.segmentors.Segmentor``
(``segment_image`` and a ``needs_image`` flag); those classes work as is.
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
