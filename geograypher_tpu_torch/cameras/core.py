"""Camera model core: camera batches as torch tensors + the host-side set.

Port of the parts of ``geograypher_tpu/cameras/core.py`` that the
aggregation, render and detection paths use: camera batches, the batched
projection and pixel rays, and the camera set with its detection
triangulation.  Conventions are the JAX package's: ``cam_to_world``
is a 4x4 transform in the photogrammetry local frame, the camera looks
along +Z with x right and y down, ``f`` is in pixels and ``cx, cy`` are
principal-point offsets from the image centre.  Host geometry stays
float64 numpy; a :class:`CameraBatch` holds float32 tensors on a device.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import logging
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from geograypher_tpu_torch.constants import EXAMPLE_INTRINSICS, PATH_TYPE
from geograypher_tpu_torch.utils import crs as crs_utils
from geograypher_tpu_torch.utils.device import resolve_device
from geograypher_tpu_torch.utils.files import ensure_containing_folder
from geograypher_tpu_torch.utils.geometric import (
    angle_between,
    projection_onto_spanned_plane,
)
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

    @property
    def n_cameras(self) -> int:
        return self.cam_to_world.shape[0]

    @property
    def positions(self) -> torch.Tensor:
        """(N, 3) camera centres in the local frame, on the batch's
        device."""
        return self.cam_to_world[:, :3, 3]

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


# ---------------------------------------------------------------------------
# Batched projection math on the device.  Every product with a rotation is
# a sum of elementwise products (no matmul, so no TF32 on the card), as
# the JAX package runs them at full float32 (Precision.HIGHEST).
# ---------------------------------------------------------------------------


def _rotate(points: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """``points @ rot.T`` over the last axis, as elementwise sums:
    points (..., P, 3) and rot (..., 3, 3) broadcast over the leading
    axes."""
    p = points[..., :, None, :]  # (..., P, 1, 3)
    r = rot[..., None, :, :]  # (..., 1, 3, 3)
    return p[..., 0] * r[..., 0] + p[..., 1] * r[..., 1] + p[..., 2] * r[..., 2]


def world_to_camera_frame(points: torch.Tensor, world_to_cam: torch.Tensor) -> torch.Tensor:
    """Transform (V, 3) local-frame points into one camera's frame
    (``world_to_cam`` (4, 4)); returns (V, 3) with +Z forward."""
    return _rotate(points, world_to_cam[:3, :3]) + world_to_cam[:3, 3]


def camera_frame_to_pixels(
    pts_cam: torch.Tensor,
    f,
    cx,
    cy,
    image_width: int,
    image_height: int,
    use_principal_point: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pinhole projection of camera-frame points to pixel coordinates.

    Returns (xy, depth, valid): ``xy`` (V, 2) continuous ``(col, row)``
    coordinates, ``depth`` the +Z camera depth, ``valid`` the points in
    front of the camera and inside the image.
    """
    z = pts_cam[..., 2]
    eps = torch.tensor(1e-12, dtype=pts_cam.dtype, device=pts_cam.device)
    safe_z = torch.where(z.abs() < eps, eps, z)
    px = f * pts_cam[..., 0] / safe_z + image_width / 2.0
    py = f * pts_cam[..., 1] / safe_z + image_height / 2.0
    if use_principal_point:
        px = px + cx
        py = py + cy
    xy = torch.stack([px, py], dim=-1)
    in_front = z > 0
    in_image = (px >= 0) & (px < image_width) & (py >= 0) & (py < image_height)
    return xy, z, in_front & in_image


def project_points(
    batch: CameraBatch,
    points: torch.Tensor,
    use_principal_point: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project (V, 3) points through all cameras in the batch.

    Returns xy (N, V, 2) pixel (col, row) coordinates, depth (N, V)
    camera-frame depth and valid (N, V), in front and inside the image.
    """
    w2c = batch.world_to_cam
    pts_cam = _rotate(points[None], w2c[:, :3, :3]) + w2c[:, None, :3, 3]
    return camera_frame_to_pixels(
        pts_cam, batch.f[:, None], batch.cx[:, None], batch.cy[:, None],
        batch.image_width, batch.image_height,
        use_principal_point=use_principal_point,
    )


def pixel_rays(
    batch: CameraBatch,
    pixel_coords_ij: torch.Tensor,
    line_length: float = 10.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rays from each camera centre through given (i, j) pixels.

    The direction through pixel (i, j) is the normalized ``((x - ppx) /
    f, (y - ppy) / f, 1)`` with the FULL principal point ``pp = (W/2 +
    cx, H/2 + cy)``, scaled to ``line_length`` and expressed in the local
    frame (reference ``PhotogrammetryCamera.cast_rays``,
    cameras.py:574-631).

    Args:
        batch: cameras.
        pixel_coords_ij: (N, P, 2) per-camera (row, col) pixel coords.
        line_length: world-frame length of each returned segment.

    Returns (starts, ends), each (N, P, 3): the camera centres
    (broadcast) and the segments' ends, in the local frame.
    """
    x = pixel_coords_ij[..., 1]
    y = pixel_coords_ij[..., 0]
    f = batch.f[:, None]
    ppx = batch.image_width / 2.0 + batch.cx[:, None]
    ppy = batch.image_height / 2.0 + batch.cy[:, None]
    dirs = torch.stack([(x - ppx) / f, (y - ppy) / f, torch.ones_like(x)], dim=-1)
    norm = torch.sqrt(dirs[..., 0] * dirs[..., 0] + dirs[..., 1] * dirs[..., 1]
                      + dirs[..., 2] * dirs[..., 2])
    dirs = dirs / norm[..., None]
    world_dirs = _rotate(dirs, batch.cam_to_world[:, :3, :3])
    starts = batch.cam_to_world[:, None, :3, 3].expand_as(world_dirs)
    ends = starts + world_dirs * line_length
    return starts, ends


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

    def export_images(self, output_folder: PATH_TYPE, copy: bool = False) -> None:
        """Symlink (or, with ``copy``, copy) each camera's image into
        ``output_folder`` under its own name; a missing image is logged
        and skipped when copying."""
        for i in range(len(self)):
            src = self.get_image_filename(i, absolute=True)
            if src is None:
                continue
            dst = ensure_containing_folder(Path(output_folder) / src.name)
            if copy:
                try:
                    shutil.copy(src, dst)
                except FileNotFoundError:
                    logging.getLogger(__name__).warning("Could not find %s", src)
            elif not dst.exists():
                os.symlink(src, dst)

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

    def get_camera_view_angles(
        self,
        indices: Optional[Sequence[int]] = None,
        in_deg: bool = True,
    ) -> np.ndarray:
        """(N, 2) off-nadir (pitch, yaw) of each camera's view, in float64
        on the host.

        Pitch is the view vector's tilt from nadir within the camera's
        up / nadir plane, yaw within its right / nadir plane, both in the
        UTM frame of the cameras' mean position; the set must be
        georeferenced (``local_to_epsg_4978_transform``).
        """
        if self.local_to_epsg_4978_transform is None:
            raise ValueError(
                "View angles need a georeferenced camera set "
                "(local_to_epsg_4978_transform is None)"
            )
        if indices is None:
            indices = range(len(self))
        # origin, one unit along the view (+Z), up (-Y) and right (+X)
        probes = np.array(
            [[0, 0, 0, 1], [0, 0, 1, 1], [0, -1, 0, 1], [1, 0, 0, 1]],
            dtype=np.float64,
        ).T
        c2w = np.stack([self.cam_to_world_transforms[i] for i in indices], axis=0)
        ecef = np.einsum("ij,njk->nik", self.local_to_epsg_4978_transform,
                         c2w @ probes)
        ecef = ecef[:, :3].transpose(0, 2, 1).reshape(-1, 3)  # (N*4, 3)
        lat, lon, alt = crs_utils.ecef_to_lla(ecef[:, 0], ecef[:, 1], ecef[:, 2])
        utm = crs_utils.utm_epsg_for(np.mean(lat), np.mean(lon))
        enu = crs_utils.transform_points(
            np.stack([lat, lon, alt], axis=1), 4326, utm
        ).reshape(-1, 4, 3)
        view = enu[:, 1] - enu[:, 0]
        up = enu[:, 2] - enu[:, 0]
        right = enu[:, 3] - enu[:, 0]
        nadir = np.array([0.0, 0.0, -1.0])
        pitch = angle_between(projection_onto_spanned_plane(view, up, nadir), nadir)
        yaw = angle_between(projection_onto_spanned_plane(view, right, nadir), nadir)
        out = np.stack([pitch, yaw], axis=1)
        return np.rad2deg(out) if in_deg else out

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

    def sensor_groups(self) -> Dict[Tuple[int, int], List[int]]:
        """Camera indices grouped by (width, height): each group forms one
        :class:`CameraBatch`."""
        groups: Dict[Tuple[int, int], List[int]] = {}
        for i, sid in enumerate(self.sensor_IDs):
            s = self.sensors[sid]
            key = (int(s["image_width"]), int(s["image_height"]))
            groups.setdefault(key, []).append(i)
        return groups

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

    # -- detection triangulation -------------------------------------------

    def get_local_scale(self) -> float:
        """Meters per local unit: cbrt of the local->ECEF determinant
        (reference utils/geometric.py:97-113)."""
        t = self.local_to_epsg_4978_transform
        if t is None:
            return 1.0
        return float(np.cbrt(np.linalg.det(t[:3, :3])))

    def calc_line_segments(
        self,
        detector,
        boundaries=None,
        ray_length_local: float = 1e3,
        out_dir=None,
        limit_ray_length_local: Optional[float] = None,
        limit_angle_from_vert: Optional[float] = None,
        device="cuda",
        stats: Optional[dict] = None,
    ):
        """Detection centres -> local-frame rays, filtered and clipped
        (reference cameras.py:1483-1596), as the JAX package's.

        Per camera: the detector's centres, a ray through each (on
        ``device``); then, in this order, rays farther than
        ``limit_angle_from_vert`` from vertical dropped, the rest clipped
        between the (ceiling, floor) covering meshes of ``boundaries``,
        and the length cap measured from the original origins (with or
        without the clip).  Returns ``{"ray_starts", "ray_ends",
        "ray_IDs"}``, or the path of ``line_segments.npz`` in ``out_dir``.
        ``stats``, when given, gets the seconds of the rays (``rays_s``)
        and of the clip (``clip_s``).
        """
        from geograypher_tpu_torch.ops.raycast import clip_line_segments

        device = resolve_device(device, "CameraSet.calc_line_segments")
        t0 = time.perf_counter()
        all_starts, all_ends, all_ids = [], [], []
        for cam_ind in range(len(self)):
            fname = str(self.get_image_filename(cam_ind))
            centers = np.asarray(detector.get_detection_centers(fname))
            if centers.size == 0:
                continue
            batch = self.get_camera_batch([cam_ind], device=device)
            starts, ends = pixel_rays(
                batch,
                torch.as_tensor(centers[None], dtype=torch.float32).to(device),
                line_length=ray_length_local,
            )
            all_starts.append(starts[0].cpu().numpy())
            all_ends.append(ends[0].cpu().numpy())
            all_ids.append(np.full(len(centers), cam_ind))
        t1 = time.perf_counter()
        if not all_starts:
            data = {
                "ray_starts": np.zeros((0, 3)),
                "ray_ends": np.zeros((0, 3)),
                "ray_IDs": np.zeros((0,), int),
            }
        else:
            starts = np.concatenate(all_starts)
            ends = np.concatenate(all_ends)
            ids = np.concatenate(all_ids)
            keep = np.ones(len(starts), dtype=bool)
            if limit_angle_from_vert is not None:
                dirs = ends - starts
                dirs = dirs / np.linalg.norm(dirs, axis=1, keepdims=True)
                angle = np.arccos(np.clip(-dirs[:, 2], -1.0, 1.0))
                keep &= angle <= limit_angle_from_vert
            starts, ends, ids = starts[keep], ends[keep], ids[keep]
            origins = starts.copy()
            if boundaries is not None:
                (ceil_v, ceil_f), (floor_v, floor_f) = boundaries
                starts, ends, valid = clip_line_segments(
                    starts, ends, ceil_v[ceil_f], floor_v[floor_f], device=device
                )
            else:
                valid = np.ones(len(starts), dtype=bool)
            if limit_ray_length_local is not None:
                length = np.linalg.norm(ends - origins, axis=1)
                valid &= length <= limit_ray_length_local
            data = {"ray_starts": starts[valid], "ray_ends": ends[valid],
                    "ray_IDs": ids[valid]}
        if stats is not None:
            stats.update(rays_s=t1 - t0, clip_s=time.perf_counter() - t1)
        if out_dir is not None:
            path = Path(out_dir) / "line_segments.npz"
            np.savez(path, **data)
            return path
        return data

    def triangulate_detections(
        self,
        detector,
        ray_length_meters: float = 1e3,
        boundaries=None,
        limit_ray_length_meters: Optional[float] = None,
        limit_angle_from_vert: Optional[float] = None,
        similarity_threshold_meters: float = 0.1,
        transform: Optional[Callable] = None,
        louvain_resolution: float = 1.0,
        out_dir: Optional[PATH_TYPE] = None,
        device="cuda",
        stats: Optional[dict] = None,
    ) -> np.ndarray:
        """Per-image detections -> triangulated 3D object locations
        (reference cameras.py:1275-1480): rays -> pairwise-intersection
        graph -> Louvain communities -> per-community triangulation.

        Cached per stage in ``out_dir`` (``line_segments.npz``,
        ``edge_weights.json``, ``communities.npz``, the JAX package's
        files): a stage whose file is there is read back instead of run,
        whichever package wrote it.  Returns (M, 3) (lat, lon, alt) when
        georeferenced, else local points.  The device work runs on
        ``device`` (the card by default; raises without one).  ``stats``,
        when given, gets each stage's seconds (``rays_s``, ``clip_s``,
        ``blocks_device_s``, ``format_s``, ``louvain_s``,
        ``average_s``) for the stages that ran.
        """
        from geograypher_tpu_torch.ops.triangulate import (
            calc_communities,
            calc_graph_weights,
        )

        device = resolve_device(device, "CameraSet.triangulate_detections")
        if out_dir is not None:
            out_dir = Path(out_dir)
            out_dir.mkdir(parents=True, exist_ok=True)
        scale = self.get_local_scale()

        seg_path = out_dir / "line_segments.npz" if out_dir else None
        if seg_path is not None and seg_path.is_file():
            data = dict(np.load(seg_path))
        else:
            data = self.calc_line_segments(
                detector,
                boundaries=boundaries,
                ray_length_local=ray_length_meters / scale,
                limit_ray_length_local=(
                    limit_ray_length_meters / scale
                    if limit_ray_length_meters is not None
                    else None
                ),
                limit_angle_from_vert=limit_angle_from_vert,
                out_dir=out_dir,
                device=device,
                stats=stats,
            )
            if out_dir is not None:
                data = dict(np.load(data))

        starts, ends, ray_IDs = (
            data["ray_starts"],
            data["ray_ends"],
            data["ray_IDs"],
        )
        edges_path = out_dir / "edge_weights.json" if out_dir else None
        if edges_path is not None and edges_path.is_file():
            with edges_path.open() as fh:
                edge_weights = [tuple(e) for e in json.load(fh)]
        else:
            edge_weights = calc_graph_weights(
                starts,
                ends,
                ray_IDs,
                similarity_threshold=similarity_threshold_meters / scale,
                transform=transform,
                out_dir=out_dir,
                device=device,
                stats=stats,
            )
            if out_dir is not None:
                with open(edge_weights) as fh:
                    edge_weights = [tuple(e) for e in json.load(fh)]

        comm_path = out_dir / "communities.npz" if out_dir else None
        if comm_path is not None and comm_path.is_file():
            result = dict(np.load(comm_path))
        else:
            result = calc_communities(
                starts,
                ends,
                edge_weights,
                louvain_resolution=louvain_resolution,
                transform_to_epsg_4978=self.local_to_epsg_4978_transform,
                out_dir=out_dir,
                device=device,
                stats=stats,
            )
            if out_dir is not None:
                result = dict(np.load(result))

        if "community_points_latlon" in result:
            return result["community_points_latlon"]
        return result["community_points"]

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

    def n_image_channels(self) -> int:
        return 3
