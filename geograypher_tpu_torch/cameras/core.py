"""Camera model core: camera batches as torch tensors + the host-side set.

Port of the parts of ``geograypher_tpu/cameras/core.py`` that the
aggregation and render paths use.  Conventions are the JAX package's: ``cam_to_world``
is a 4x4 transform in the photogrammetry local frame, the camera looks
along +Z with x right and y down, ``f`` is in pixels and ``cx, cy`` are
principal-point offsets from the image centre.  Host geometry stays
float64 numpy; a :class:`CameraBatch` holds float32 tensors on a device.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from geograypher_tpu_torch.constants import EXAMPLE_INTRINSICS, PATH_TYPE
from geograypher_tpu_torch.utils import crs as crs_utils
from geograypher_tpu_torch.utils.device import resolve_device
from geograypher_tpu_torch.utils.io import read_image_or_numpy, resize_area
from geograypher_tpu_torch.utils.vector import (
    Polygon,
    VectorData,
    points_near_polygons,
)

# guards every camera set's raw-image cache (a few dict operations a read)
_IMAGE_CACHE_LOCK = threading.Lock()

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


def distortion_vector_to_dict(vec: np.ndarray) -> Dict[str, float]:
    return {
        k: float(v) for k, v in zip(DISTORTION_KEYS, np.asarray(vec)) if v != 0.0
    }


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
    device="cuda",
) -> CameraBatch:
    """Build a CameraBatch from host arrays; world_to_cam is inverted in
    float64 before the cast.  ``device`` is the card by default (raises
    without one); pass ``device="cpu"`` for CPU work."""
    device = resolve_device(device, "make_camera_batch")
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

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return self.get_subset_cameras(range(*idx.indices(len(self))))
        return self.get_subset_cameras([idx])

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

    def get_subset_ROI(
        self,
        ROI,
        buffer_radius: float = 0.0,
        is_geospatial: Optional[bool] = None,
    ) -> "CameraSet":
        """Cameras located within (a buffer of) the ROI geometry.

        Geospatial ROIs are compared against camera lon/lats in the ROI's
        projected CRS; non-geospatial ROIs against local-frame locations.
        The buffer is an exact distance test
        (:func:`~geograypher_tpu_torch.utils.vector.points_near_polygons`),
        where the JAX package buffers on a raster grid.
        """
        if isinstance(ROI, Polygon):
            ROI = VectorData([ROI], epsg=4326 if is_geospatial else None)
        elif not isinstance(ROI, VectorData):
            ROI = VectorData.read_file(ROI)
        if is_geospatial is None:
            is_geospatial = ROI.epsg is not None

        if is_geospatial:
            ROI = ROI.ensure_projected()
            lon_lats = self.get_lon_lat_coords()
            lla = np.array([[ll[1], ll[0], 0.0] for ll in lon_lats]).reshape(-1, 3)
            pts = crs_utils.transform_points(lla, 4326, ROI.epsg)[:, :2]
        else:
            pts = self.get_camera_locations()[:, :2]

        polys = [g for g in ROI.geometries if isinstance(g, Polygon)]
        inside = points_near_polygons(polys, pts, buffer_radius)
        return self.get_subset_cameras(np.where(inside)[0])

    def get_image_filename(self, index: int, absolute: bool = True):
        f = self.image_filenames[index]
        if f is None:
            return None
        return Path(f).absolute() if absolute else Path(f)

    def find_missing_images(self) -> List[Path]:
        return [
            f
            for f in self.image_filenames
            if f is not None and not Path(f).exists()
        ]

    def get_camera_locations(self) -> np.ndarray:
        """(N, 3) camera centers in the local frame."""
        if len(self) == 0:
            return np.zeros((0, 3))
        return np.stack(
            [t[:3, 3] / t[3, 3] for t in self.cam_to_world_transforms], axis=0
        )

    def get_lon_lat_coords(self) -> List[Optional[Tuple[float, float]]]:
        """Per-camera (lon, lat); derived from the transforms if unset."""
        if all(ll is not None for ll in self.lon_lats):
            return list(self.lon_lats)
        if self.local_to_epsg_4978_transform is None:
            return list(self.lon_lats)
        locs = self.get_camera_locations()
        hom = np.concatenate([locs, np.ones((len(locs), 1))], axis=1)
        ecef = (self.local_to_epsg_4978_transform @ hom.T).T[:, :3]
        lat, lon, _ = crs_utils.ecef_to_lla(ecef[:, 0], ecef[:, 1], ecef[:, 2])
        self.lon_lats = list(zip(lon, lat))
        return list(self.lon_lats)

    def get_camera_hash(self, include_image_hash: bool = False) -> str:
        """Content hash of the set's geometry, INCLUDING distortion
        parameters: this hash keys the pix2face disk cache, and a
        distortion-warped map is stale the moment any coefficient changes.
        Equal to the JAX package's digest for an equal set."""

        def canonical(v):
            if isinstance(v, dict):
                return tuple(sorted((k, canonical(x)) for k, x in v.items()))
            if isinstance(v, (list, tuple, np.ndarray)):
                return tuple(canonical(x) for x in np.asarray(v).reshape(-1))
            if isinstance(v, (np.floating, np.integer)):
                return v.item()
            return v

        hasher = hashlib.sha256()
        for i, t in enumerate(self.cam_to_world_transforms):
            hasher.update(np.ascontiguousarray(t).tobytes())
            sensor = self.sensors[self.sensor_IDs[i]]
            hasher.update(
                repr(sorted((k, canonical(v)) for k, v in sensor.items())).encode()
            )
            if include_image_hash and self.image_filenames[i] is not None:
                hasher.update(str(self.image_filenames[i]).encode())
        return hasher.hexdigest()

    def get_camera_batch(
        self,
        indices: Optional[Sequence[int]] = None,
        image_scale: float = 1.0,
        device="cuda",
    ) -> CameraBatch:
        """Stacked CameraBatch on ``device`` for the given indices
        (default: all); the cameras must share an image size.  ``device``
        is the card by default (raises without one); pass
        ``device="cpu"`` for CPU work."""
        device = resolve_device(device, "CameraSet.get_camera_batch")
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
        raw images in a small LRU cache; resizing runs per call, as cv2's
        INTER_AREA does it (:func:`~geograypher_tpu_torch.utils.io.resize_area`:
        area averaging to shrink, its linear variant to enlarge)."""
        fname = self.get_image_filename(index)
        if fname is None:
            raise FileNotFoundError(f"Camera {index} has no image filename")
        key = str(fname)
        # the survey pipeline's worker threads read images concurrently
        with _IMAGE_CACHE_LOCK:
            cache = getattr(self, "_image_cache", None)
            if cache is None:
                cache = self._image_cache = collections.OrderedDict()
            img = cache.get(key)
            if img is not None:
                cache.move_to_end(key)
        if img is None:
            img = read_image_or_numpy(fname)
            if self.image_cache_size > 0:
                with _IMAGE_CACHE_LOCK:
                    cache[key] = img
                    while len(cache) > self.image_cache_size:
                        cache.popitem(last=False)
        if image_scale != 1.0:
            new_w = int(img.shape[1] * image_scale)
            new_h = int(img.shape[0] * image_scale)
            img = resize_area(img, new_w, new_h)
        return img
