"""Camera model core: camera batches as torch tensors + the host-side set.

Port of the parts of ``geograypher_tpu/cameras/core.py`` that the
aggregation path uses.  Conventions are the JAX package's: ``cam_to_world``
is a 4x4 transform in the photogrammetry local frame, the camera looks
along +Z with x right and y down, ``f`` is in pixels and ``cx, cy`` are
principal-point offsets from the image centre.  Host geometry stays
float64 numpy; a :class:`CameraBatch` holds float32 tensors on a device.
"""

from __future__ import annotations

import collections
import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from geograypher_tpu_torch.constants import EXAMPLE_INTRINSICS, PATH_TYPE

# Distortion parameter vector layout (Brown-Conrady, Metashape order).
DISTORTION_KEYS = ("k1", "k2", "k3", "k4", "p1", "p2", "b1", "b2")


def distortion_dict_to_vector(params: Optional[Dict[str, float]]) -> np.ndarray:
    vec = np.zeros((len(DISTORTION_KEYS),), dtype=np.float64)
    if params:
        unknown = set(params) - set(DISTORTION_KEYS)
        if unknown:
            raise ValueError(f"Unexpected distortion params found: {sorted(unknown)}")
        for i, k in enumerate(DISTORTION_KEYS):
            vec[i] = float(params.get(k, 0.0))
    return vec


@dataclasses.dataclass(frozen=True)
class CameraBatch:
    """N cameras sharing one image size, as stacked tensors on a device."""

    cam_to_world: torch.Tensor  # (N, 4, 4) float32
    world_to_cam: torch.Tensor  # (N, 4, 4) float32
    f: torch.Tensor  # (N,) focal length in pixels
    cx: torch.Tensor  # (N,) principal point offset from the centre
    cy: torch.Tensor  # (N,)
    distortion: torch.Tensor  # (N, 8) DISTORTION_KEYS order
    image_width: int
    image_height: int

    def scaled(self, image_scale: float) -> "CameraBatch":
        """The batch at a scaled image resolution: sizes round with int(),
        intrinsics and the pixel-unit affinity terms b1/b2 scale
        linearly."""
        if image_scale == 1.0:
            return self
        s = float(image_scale)
        pix_scale = torch.tensor(
            [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, s, s],
            dtype=self.distortion.dtype, device=self.distortion.device,
        )
        return dataclasses.replace(
            self,
            f=self.f * s,
            cx=self.cx * s,
            cy=self.cy * s,
            distortion=self.distortion * pix_scale,
            image_width=int(self.image_width * s),
            image_height=int(self.image_height * s),
        )


def make_camera_batch(
    cam_to_world: np.ndarray,
    f,
    cx,
    cy,
    image_width: int,
    image_height: int,
    distortion: Optional[np.ndarray] = None,
    dtype=torch.float32,
    device="cpu",
) -> CameraBatch:
    """Build a CameraBatch from host arrays; world_to_cam is inverted in
    float64 before the cast."""
    c2w = np.asarray(cam_to_world, dtype=np.float64)
    if c2w.ndim == 2:
        c2w = c2w[None]
    n = c2w.shape[0]
    w2c = np.linalg.inv(c2w)
    if distortion is None:
        distortion = np.zeros((n, len(DISTORTION_KEYS)))

    def dev(a, shape):
        a = np.broadcast_to(np.asarray(a, dtype=np.float64), shape)
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return CameraBatch(
        cam_to_world=dev(c2w, c2w.shape),
        world_to_cam=dev(w2c, w2c.shape),
        f=dev(f, (n,)),
        cx=dev(cx, (n,)),
        cy=dev(cy, (n,)),
        distortion=dev(distortion, (n, len(DISTORTION_KEYS))),
        image_width=int(image_width),
        image_height=int(image_height),
    )


class CameraSet:
    """Ordered collection of cameras in one local frame.

    Stores per-camera metadata (poses, filenames, sensor ids, lon/lat) on
    the host and hands out device :class:`CameraBatch` es.
    """

    #: raw images kept in memory per set, least recently used dropped
    image_cache_size: int = 16

    def __init__(
        self,
        cam_to_world_transforms: Sequence[np.ndarray],
        intrinsic_params_per_sensor_type: Dict[int, Optional[dict]] = None,
        image_filenames: Optional[Sequence[Optional[PATH_TYPE]]] = None,
        lon_lats: Optional[Sequence[Optional[Tuple[float, float]]]] = None,
        image_folder: Optional[PATH_TYPE] = None,
        sensor_IDs: Optional[Sequence[int]] = None,
        validate_images: bool = False,
        local_to_epsg_4978_transform: Optional[np.ndarray] = None,
    ):
        n = len(cam_to_world_transforms)
        if intrinsic_params_per_sensor_type is None:
            intrinsic_params_per_sensor_type = {0: dict(EXAMPLE_INTRINSICS)}
        if sensor_IDs is None:
            sensor_IDs = [sorted(intrinsic_params_per_sensor_type)[0]] * n
        if image_filenames is None:
            image_filenames = [None] * n
        if lon_lats is None:
            lon_lats = [None] * n

        # drop cameras whose sensor has no calibration, or whose image is
        # missing when validate_images is set
        keep = []
        for i in range(n):
            if intrinsic_params_per_sensor_type.get(sensor_IDs[i]) is None:
                continue
            if validate_images:
                fname = image_filenames[i]
                if fname is None or not Path(fname).exists():
                    continue
            keep.append(i)

        self.cam_to_world_transforms = [
            np.asarray(cam_to_world_transforms[i], dtype=np.float64) for i in keep
        ]
        self.image_filenames = [
            Path(image_filenames[i]) if image_filenames[i] is not None else None
            for i in keep
        ]
        self.lon_lats = [lon_lats[i] for i in keep]
        self.sensor_IDs = [sensor_IDs[i] for i in keep]
        self.sensors = dict(intrinsic_params_per_sensor_type)
        self.image_folder = Path(image_folder) if image_folder is not None else None
        self.local_to_epsg_4978_transform = (
            np.asarray(local_to_epsg_4978_transform, dtype=np.float64)
            if local_to_epsg_4978_transform is not None
            else None
        )
        self._batch_cache: Dict[Tuple, CameraBatch] = {}

    def __len__(self) -> int:
        return len(self.cam_to_world_transforms)

    def get_local_to_epsg_4978_transform(self):
        return self.local_to_epsg_4978_transform

    def get_subset_cameras(self, indices) -> "CameraSet":
        indices = [int(i) for i in indices]
        sub = CameraSet.__new__(CameraSet)
        sub.cam_to_world_transforms = [self.cam_to_world_transforms[i] for i in indices]
        sub.image_filenames = [self.image_filenames[i] for i in indices]
        sub.lon_lats = [self.lon_lats[i] for i in indices]
        sub.sensor_IDs = [self.sensor_IDs[i] for i in indices]
        sub.sensors = self.sensors
        sub.image_folder = self.image_folder
        sub.local_to_epsg_4978_transform = self.local_to_epsg_4978_transform
        sub._batch_cache = {}
        return sub

    def get_subset_by_folder(self, folder_names) -> "CameraSet":
        """Cameras whose image path contains one of the folders."""
        folders = [str(f) for f in np.atleast_1d(folder_names)]
        idx = [
            i
            for i, f in enumerate(self.image_filenames)
            if f is not None and any(fol in str(f.parent) for fol in folders)
        ]
        return self.get_subset_cameras(idx)

    def get_subset_by_regex(self, pattern: str) -> "CameraSet":
        """Cameras whose filename matches the regex."""
        import re

        prog = re.compile(pattern)
        idx = [
            i
            for i, f in enumerate(self.image_filenames)
            if f is not None and prog.search(str(f))
        ]
        return self.get_subset_cameras(idx)

    def get_subset_every_nth(self, n: int) -> "CameraSet":
        return self.get_subset_cameras(range(0, len(self), max(int(n), 1)))

    def get_image_filename(self, index: int, absolute: bool = True):
        f = self.image_filenames[index]
        if f is None:
            return None
        return Path(f).absolute() if absolute else Path(f)

    def get_camera_batch(
        self,
        indices: Optional[Sequence[int]] = None,
        image_scale: float = 1.0,
        device="cpu",
    ) -> CameraBatch:
        """Stacked CameraBatch on ``device`` for the given indices
        (default: all); the cameras must share an image size."""
        if indices is None:
            indices = list(range(len(self)))
        indices = tuple(int(i) for i in indices)
        key = (indices, float(image_scale), str(torch.device(device)))
        if key in self._batch_cache:
            return self._batch_cache[key]
        sensors = [self.sensors[self.sensor_IDs[i]] for i in indices]
        sizes = {(int(s["image_width"]), int(s["image_height"])) for s in sensors}
        if len(sizes) != 1:
            raise ValueError(
                f"Cameras with mixed image sizes {sizes} cannot share a batch"
            )
        (w, h), = sizes
        batch = make_camera_batch(
            np.stack([self.cam_to_world_transforms[i] for i in indices], axis=0),
            np.array([s["f"] for s in sensors]),
            np.array([s.get("cx", 0.0) for s in sensors]),
            np.array([s.get("cy", 0.0) for s in sensors]),
            w,
            h,
            np.stack([distortion_dict_to_vector(s.get("distortion_params"))
                      for s in sensors]),
            device=device,
        )
        if image_scale != 1.0:
            batch = batch.scaled(image_scale)
        self._batch_cache[key] = batch
        return batch

    def get_image_by_index(self, index: int, image_scale: float = 1.0) -> np.ndarray:
        """Load camera ``index``'s image (.npy or an image file), keeping
        raw images in a small LRU cache; resizing runs per call."""
        from geograypher_tpu.utils.io import read_image_or_numpy

        fname = self.get_image_filename(index)
        if fname is None:
            raise FileNotFoundError(f"Camera {index} has no image filename")
        cache = getattr(self, "_image_cache", None)
        if cache is None:
            cache = self._image_cache = collections.OrderedDict()
        key = str(fname)
        if key in cache:
            cache.move_to_end(key)
            img = cache[key]
        else:
            img = read_image_or_numpy(fname)
            if self.image_cache_size > 0:
                cache[key] = img
                while len(cache) > self.image_cache_size:
                    cache.popitem(last=False)
        if image_scale != 1.0:
            import cv2

            new_w = int(img.shape[1] * image_scale)
            new_h = int(img.shape[0] * image_scale)
            img = cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_AREA)
        return img
