"""TexturedMesh: the multiview aggregation engine, in PyTorch.

Port of the aggregation path of ``geograypher_tpu/meshes/mesh.py``.
Geometry stays float64 numpy on the host (ECEF when georeferenced);
per-view work runs on ``device`` over float32 triangles in the cameras'
local frame: camera transform, triangle setup, tile binning, the raster
kernel and the counts kernel (see ``ops/rasterize.py``).

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): texture loading, ROI cropping, downsampling and export (A6), the
pix2face / render path with its distortion remap (A13), planned
aggregation (A7).
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import typing
from pathlib import Path

import numpy as np
import torch

from geograypher_tpu_torch.cameras.core import CameraSet
from geograypher_tpu_torch.constants import (
    EARTH_CENTERED_EARTH_FIXED_EPSG,
    LAT_LON_EPSG,
    PATH_TYPE,
)
from geograypher_tpu_torch.ops.aggregate import (
    accumulate_view,
    finalize_aggregation,
    init_aggregation,
    project_image_to_faces,
)
from geograypher_tpu_torch.ops.onehot import onehot_to_class
from geograypher_tpu_torch.ops.rasterize import (
    RasterConfig,
    bin_all,
    fused_view_class_counts,
    rasterize_setup,
    setup_from_soa,
    tri_to_soa,
)
from geograypher_tpu_torch.utils import crs as crs_utils
from geograypher_tpu_torch.utils import geometric
from geograypher_tpu_torch.utils.device import resolve_device
from geograypher_tpu_torch.utils.meshio import load_mesh
from geograypher_tpu_torch.utils.parsing import (
    crs_from_srs_text,
    parse_metashape_mesh_metadata,
    parse_transform_metashape,
)

logger = logging.getLogger(__name__)

DEFAULT_RASTER_CONFIG = RasterConfig(caps=(512, 128, 64, 64))


class _PinnedUpload:
    """Host arrays to ``device`` through one page-locked staging buffer,
    allocated at the first upload and reused by the next ones: the copy
    into it and the DMA out of it together take a third to a half of the
    time of a pageable ``.to(device)`` for a 4K one-hot stack.  On a CPU device
    the array is wrapped as it is."""

    def __init__(self, device: torch.device):
        self.device = device
        self._stage: typing.Optional[torch.Tensor] = None
        self._left: typing.Optional[torch.cuda.Event] = None

    def __call__(self, array: np.ndarray) -> torch.Tensor:
        host = torch.as_tensor(np.ascontiguousarray(array))
        if self.device.type != "cuda" or host.numel() == 0:
            return host.to(self.device)
        if self._left is not None:
            self._left.synchronize()  # the last image has left the buffer
        n_bytes = host.numel() * host.element_size()
        if self._stage is None or self._stage.numel() < n_bytes:
            self._stage = torch.empty(n_bytes, dtype=torch.uint8, pin_memory=True)
        stage = self._stage[:n_bytes].view(host.dtype).view(host.shape)
        stage.copy_(host)
        on_device = stage.to(self.device, non_blocking=True)
        self._left = torch.cuda.Event()
        self._left.record(torch.cuda.current_stream(self.device))
        return on_device


class TexturedMesh:
    """A triangle mesh in a geospatial frame whose per-view work runs on
    ``device``.

    Vertices are stored float64 on the host, in ECEF (EPSG:4978) when
    georeferenced or in an arbitrary local frame when not.
    """

    def __init__(
        self,
        mesh: typing.Union[PATH_TYPE, tuple],
        downsample_target: float = 1.0,
        transform_filename: typing.Optional[PATH_TYPE] = None,
        texture=None,
        texture_column_name: typing.Optional[str] = None,
        CRS: typing.Optional[int] = None,
        ROI=None,
        ROI_buffer_meters: float = 0.0,
        IDs_to_labels: typing.Optional[dict] = None,
        shift: typing.Optional[np.ndarray] = None,
        raster_config: RasterConfig = DEFAULT_RASTER_CONFIG,
        device="cuda",
    ):
        """Load geometry.

        Args:
            mesh: a mesh file (.ply/.obj/.npz) or a (verts, faces) tuple.
            transform_filename: Metashape camera XML providing the
                local -> ECEF transform, or mesh-metadata XML with CRS +
                shift.
            CRS: EPSG code the mesh vertices are in (None = local frame).
            shift: (3,) added to the vertices at load.
            device: where per-view work runs: the card ("cuda", the
                default; raises when there is none, never falls back to
                the CPU) or "cpu" when asked for explicitly.
        """
        if downsample_target != 1.0 or texture is not None or ROI is not None:
            raise NotImplementedError(
                "mesh downsampling, textures and ROI cropping are not ported "
                "yet (ROADMAP A6)"
            )
        del texture_column_name, ROI_buffer_meters  # only read with texture/ROI
        self.device = resolve_device(device, "TexturedMesh")
        self.raster_config = raster_config
        self.IDs_to_labels = dict(IDs_to_labels) if IDs_to_labels else None
        self.vertex_texture: typing.Optional[np.ndarray] = None
        self.face_texture: typing.Optional[np.ndarray] = None
        self._tri_cache: dict = {}

        if isinstance(mesh, (tuple, list)):
            verts, faces = mesh
            self.verts = np.asarray(verts, dtype=np.float64)
            self.faces = np.asarray(faces, dtype=np.int32)
        else:
            self.verts, self.faces, attrs = load_mesh(mesh)
            if "colors" in attrs:
                self.vertex_texture = attrs["colors"].astype(np.float64)
        self.CRS = CRS

        if transform_filename is not None:
            self._apply_transform_file(transform_filename)
        if shift is not None:
            self.verts = self.verts + np.asarray(shift, dtype=np.float64)
        # reproject to the internal ECEF frame when georeferenced
        if self.CRS is not None and self.CRS != EARTH_CENTERED_EARTH_FIXED_EPSG:
            self.verts = crs_utils.transform_points(
                self.verts, self.CRS, EARTH_CENTERED_EARTH_FIXED_EPSG
            )
            self.CRS = EARTH_CENTERED_EARTH_FIXED_EPSG

    def _apply_transform_file(self, transform_filename: PATH_TYPE):
        transform_filename = Path(transform_filename)
        if transform_filename.suffix.lower() != ".xml":
            return
        try:
            t = parse_transform_metashape(transform_filename)
        except (AssertionError, AttributeError):
            t = None
        if t is not None:
            # mesh verts are in the local chunk frame -> ECEF
            hom = np.concatenate([self.verts, np.ones((len(self.verts), 1))], axis=1)
            self.verts = (t @ hom.T).T[:, :3]
            self.CRS = EARTH_CENTERED_EARTH_FIXED_EPSG
            return
        crs_text, shift = parse_metashape_mesh_metadata(transform_filename)
        epsg = crs_from_srs_text(crs_text)
        if shift is not None:
            self.verts = self.verts + shift
        if epsg is not None:
            self.CRS = epsg

    @property
    def n_faces(self) -> int:
        return int(self.faces.shape[0])

    @property
    def n_verts(self) -> int:
        return int(self.verts.shape[0])

    # -- geometry -------------------------------------------------------------

    def get_vertices_in_CRS(self, output_CRS: typing.Optional[int]) -> np.ndarray:
        if output_CRS is None or self.CRS is None or output_CRS == self.CRS:
            return self.verts.copy()
        return crs_utils.transform_points(self.verts, self.CRS, output_CRS)

    def get_working_projected_CRS(self) -> int:
        """A projected (UTM) CRS for 2D geospatial math near the mesh."""
        if self.CRS is None:
            raise ValueError("Mesh is not georeferenced")
        lla = crs_utils.transform_points(self.verts[:1], self.CRS, LAT_LON_EPSG)
        return crs_utils.utm_epsg_for(lla[0, 0], lla[0, 1])

    def spatial_sort_faces(self) -> np.ndarray:
        """Reorder faces in serpentine scanline order over ground-plane
        centroids, oversized faces packed into trailing id blocks, and pin
        that tail to the global binning level (``global_from``).

        Returns the permutation applied (new_order[i] = old face index).
        """
        try:
            verts2d = self.get_vertices_in_CRS(self.get_working_projected_CRS())[:, :2]
        except ValueError:
            verts2d = self.verts[:, :2]
        order, n_regular = geometric.partitioned_face_order(
            verts2d[self.faces], return_split=True
        )
        self.faces = self.faces[order]
        if self.face_texture is not None:
            self.face_texture = self.face_texture[order]
        self.raster_config = dataclasses.replace(
            self.raster_config,
            global_from=n_regular if n_regular < len(order) else None,
        )
        self._tri_cache.clear()
        return order

    def get_verts_in_local_frame(
        self, cameras: typing.Union[CameraSet, np.ndarray, None]
    ) -> np.ndarray:
        """Vertices in the camera set's local frame, float64 on the host
        so ECEF magnitudes never reach float32."""
        if cameras is None:
            return self.verts
        t = (
            cameras.get_local_to_epsg_4978_transform()
            if isinstance(cameras, CameraSet)
            else np.asarray(cameras)
        )
        if t is None or self.CRS is None:
            return self.verts
        hom = np.concatenate([self.verts, np.ones((len(self.verts), 1))], axis=1)
        return (np.linalg.inv(t) @ hom.T).T[:, :3]

    def _frame_key(self, cameras, bin_block: int):
        t = (
            cameras.get_local_to_epsg_4978_transform()
            if isinstance(cameras, CameraSet) else None
        )
        frame = None if t is None else hashlib.sha256(t.tobytes()).hexdigest()
        return frame, int(bin_block)

    def get_tri_verts_device(
        self, cameras: typing.Optional[CameraSet], bin_block: int = 1
    ) -> torch.Tensor:
        """(F_pad, 3, 3) float32 triangles in the local frame on the
        mesh's device, F padded to a multiple of ``bin_block`` with
        degenerate triangles (which every view culls)."""
        key = ("tri",) + self._frame_key(cameras, bin_block)
        if key not in self._tri_cache:
            local = self.get_verts_in_local_frame(cameras)
            tri = local[self.faces]
            pad = -self.n_faces % bin_block
            if pad:
                center = local.mean(axis=0) if len(local) else np.zeros(3)
                tri = np.concatenate(
                    [tri, np.broadcast_to(center, (pad, 3, 3))], axis=0
                )
            self._tri_cache[key] = torch.as_tensor(
                tri, dtype=torch.float32
            ).to(self.device)
        return self._tri_cache[key]

    def _tri_soa_device(self, cameras, bin_block: int = 1) -> torch.Tensor:
        """(9, F_pad) coordinate-row triangles on the mesh's device."""
        key = ("soa",) + self._frame_key(cameras, bin_block)
        if key not in self._tri_cache:
            self._tri_cache[key] = tri_to_soa(
                self.get_tri_verts_device(cameras, bin_block)
            )
        return self._tri_cache[key]

    # -- rasterization / aggregation ----------------------------------------

    def _resolve_distortion(
        self,
        cameras: CameraSet,
        index: int,
        apply_distortion: typing.Optional[bool],
    ) -> bool:
        """None = auto: distort whenever the camera's sensor carries
        distortion parameters."""
        if apply_distortion is not None:
            return apply_distortion
        sensor = cameras.sensors[cameras.sensor_IDs[index]]
        return bool(sensor.get("distortion_params"))

    def check_raster_capacity(
        self,
        cameras: CameraSet,
        index: int = 0,
        render_img_scale: float = 1.0,
        config: typing.Optional[RasterConfig] = None,
    ) -> int:
        """Number of candidate entries the tile lists' capacities drop for
        one view's pinhole render (0 = lossless).  With level S on, the
        L0..L3 lists are counted after its diversion; level S itself has
        no capacity."""
        config = config or self.raster_config
        batch = cameras.get_camera_batch(
            [index], image_scale=render_img_scale, device=self.device
        )
        setup = setup_from_soa(
            self._tri_soa_device(cameras, config.bin_block),
            batch.world_to_cam[0], batch.f[0],
            batch.image_width, batch.image_height, config.znear,
        )
        binned, _ = bin_all(setup, config, batch.image_height, batch.image_width)
        overflow = int(binned.overflow)
        if overflow:
            logger.warning(
                "rasterizer capacity overflow: %d candidate entries dropped "
                "for view %d; increase RasterConfig.caps", overflow, index,
            )
        return overflow

    @staticmethod
    def _as_class_image(img: np.ndarray) -> typing.Optional[np.ndarray]:
        """int32 class-index image when ``img`` is an exact one-hot stack
        (finite rows are 0/1 summing to 1; all-NaN rows are unlabeled),
        else None.  The numpy reference of ``ops/onehot.py``, which
        :meth:`project_images` runs on the device instead."""
        img = np.asarray(img)
        if img.ndim != 3 or img.shape[-1] < 2:
            return None
        finite = np.isfinite(img)
        rows_f = finite.all(axis=-1)
        if not np.array_equal(rows_f, finite.any(axis=-1)):
            return None  # mixed-finite rows: not a one-hot stack
        vals = img[rows_f]
        if vals.size and (
            ((vals != 0) & (vals != 1)).any() or (vals.sum(axis=-1) != 1).any()
        ):
            return None
        cls = np.full(img.shape[:2], -1, np.int32)
        cls[rows_f] = np.argmax(img[rows_f], axis=-1)
        return cls

    def _rasterize_view(self, cameras, index, scale, apply_distortion, config):
        """One view's pinhole pix2face on the device and its overflow."""
        if self._resolve_distortion(cameras, index, apply_distortion):
            raise NotImplementedError(
                "pix2face of a distorted sensor (NN remap of the pinhole "
                "render) is not ported yet (ROADMAP A13); one-hot images "
                "take the fused path, which handles distortion"
            )
        batch = cameras.get_camera_batch([index], image_scale=scale,
                                         device=self.device)
        setup = setup_from_soa(
            self._tri_soa_device(cameras, config.bin_block),
            batch.world_to_cam[0], batch.f[0],
            batch.image_width, batch.image_height, config.znear,
        )
        p2f, binned = rasterize_setup(
            setup, config, batch.image_height, batch.image_width
        )
        return p2f, binned.overflow

    def project_images(
        self,
        cameras: CameraSet,
        batch_size: int = 1,
        aggregate_img_scale: float = 1.0,
        check_null_image: bool = False,
        **pix2face_kwargs,
    ):
        """Generator of per-view per-face (sums, counts) tensors.

        Each image is uploaded once (float64 as it is, every other dtype
        as float32) and scanned on the mesh's device by
        :func:`~geograypher_tpu_torch.ops.onehot.onehot_to_class`.  Exact
        one-hot images take the fused path
        (:func:`~geograypher_tpu_torch.ops.rasterize.fused_view_class_counts`:
        with level S on (``config.subtile``) the sub-tile raster first,
        then the raster kernel, then the counts kernel), which rasterizes
        a distorted sensor natively in its distorted pixel space.  Other
        images keep per-channel means over the pinhole pix2face.  After
        the last view it raises if any view's tile lists dropped
        candidates.
        """
        if batch_size != 1:
            raise NotImplementedError(
                "batched views are not ported yet (ROADMAP A11); the loop "
                "runs one view at a time, pass batch_size=1"
            )
        config = pix2face_kwargs.get("config") or self.raster_config
        apply_distortion = pix2face_kwargs.get("apply_distortion")
        overflow = torch.zeros((), dtype=torch.int64, device=self.device)
        upload = _PinnedUpload(self.device)
        for i in range(len(cameras)):
            img = cameras.get_image_by_index(i, aggregate_img_scale)
            if check_null_image and not np.any(np.isfinite(img)):
                yield None
                continue
            img = np.asarray(img)
            if img.dtype not in (np.float32, np.float64):
                # exact for 0 and 1, and no other value becomes 0 or 1
                img = img.astype(np.float32)
            img_dev = upload(img)
            cls = None
            if img.ndim == 3 and img.shape[-1] >= 2:
                # the one-hot scan runs where the image is; one 4-byte
                # read-back per view decides the path
                cls, violations = onehot_to_class(img_dev)
                if int(violations):
                    cls = None
            if cls is None:
                p2f, over = self._rasterize_view(
                    cameras, i, aggregate_img_scale, apply_distortion, config
                )
                overflow = torch.maximum(overflow, over)
                yield project_image_to_faces(p2f, img_dev, self.n_faces)
                continue
            batch = cameras.get_camera_batch(
                [i], image_scale=aggregate_img_scale, device=self.device
            )
            tri_soa = self._tri_soa_device(cameras, config.bin_block)
            counts, over, _ncand = fused_view_class_counts(
                tri_soa,
                batch.world_to_cam[0],
                batch.f[0],
                batch.distortion[0],
                batch.cx[0],
                batch.cy[0],
                cls,
                batch.image_width,
                batch.image_height,
                config,
                tri_soa.shape[1],
                img.shape[-1],
                self._resolve_distortion(cameras, i, apply_distortion),
            )
            overflow = torch.maximum(overflow, over)
            counts = counts[: self.n_faces]
            yield counts, counts.sum(dim=1, keepdim=True).expand_as(counts)
        worst = int(overflow)
        if worst:
            raise RuntimeError(
                f"raster capacity overflow: a view dropped {worst} candidate "
                "entries, so its counts are incomplete. Pass a RasterConfig "
                "with larger caps."
            )

    def aggregate_projected_images(
        self,
        cameras: CameraSet,
        batch_size: int = 1,
        aggregate_img_scale: float = 1.0,
        return_all: bool = False,
        use_planned="auto",
        **kwargs,
    ):
        """Average projections across views (per-view streaming loop).

        ``use_planned=True`` asks for the census-bucketed planner, which
        is not ported yet; ``"auto"`` and ``False`` stream.

        Returns (average_projections (F, C) numpy, additional_information
        dict).
        """
        if use_planned is True:
            raise NotImplementedError(
                "planned aggregation is not ported yet (ROADMAP A7); use "
                "use_planned='auto' or False to stream"
            )
        state = None
        all_projections = []
        for proj in self.project_images(
            cameras,
            batch_size=batch_size,
            aggregate_img_scale=aggregate_img_scale,
            **kwargs,
        ):
            if proj is None:
                continue
            sums, counts = proj
            if state is None:
                state = init_aggregation(self.n_faces, sums.shape[1], self.device)
            state = accumulate_view(state, sums, counts)
            if return_all:
                s, c = sums.cpu().numpy(), counts.cpu().numpy()
                with np.errstate(invalid="ignore"):
                    all_projections.append(
                        np.where(c > 0, s / np.maximum(c, 1), np.nan)
                    )
        if state is None:
            raise ValueError("No images to aggregate")
        avg = finalize_aggregation(state).cpu().numpy()
        additional = {
            "projection_counts": state.view_count.cpu().numpy(),
            "summed_projections": state.value_sum.cpu().numpy(),
        }
        if return_all:
            additional["all_projections"] = all_projections
        return avg, additional
