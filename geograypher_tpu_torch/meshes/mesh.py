"""TexturedMesh: the multiview projection engine, in PyTorch.

Port of the aggregation and render paths of
``geograypher_tpu/meshes/mesh.py``.  Geometry and textures stay float64
numpy on the host (ECEF when georeferenced); per-view work runs on
``device`` over float32 triangles in the cameras' local frame: camera
transform, triangle setup, tile binning, the raster kernel, then either
the counts kernel (aggregation, see ``ops/rasterize.py``) or the
distortion remap and the texture gather (rendering).

Large surveys of one-hot label images aggregate through the
census-bucketed planner (``parallel/planner.py``): caps sized per view
from a census, overflowing views re-sized and re-run instead of raising.

Chunked aggregation and rendering live in ``meshes/chunked.py``, the
survey pipeline over a list of devices in ``parallel/pipeline.py``.

The detection workflow's pieces live here too: the exact per-class
vector export and the covering meshes that clip detection rays; sparse
per-face instance counts are in ``meshes/sparse.py``.

The DTM workflows sample a GeoTIFF per vertex on the host
(``utils/raster.py``): height above ground, the ground-class relabel and
raster textures.  The orthographic products (``ortho_pix2face``, the
raster mode of the vector export, polygon labelling) render a nadir
camera far above the footprint through the same raster chain, tiled past
``max_pixels``.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import logging
import os
import time
import typing
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from geograypher_tpu_torch.cameras.core import CameraSet, distortion_dict_to_vector
from geograypher_tpu_torch.cameras.distortion import DistortionEngine, remap_image_torch
from geograypher_tpu_torch.constants import (
    CACHE_FOLDER,
    EARTH_CENTERED_EARTH_FIXED_EPSG,
    LAT_LON_EPSG,
    PATH_TYPE,
)
from geograypher_tpu_torch.ops.aggregate import (
    accumulate_view,
    face_to_vert_texture,
    finalize_aggregation,
    init_aggregation,
    project_image_to_faces,
    render_texture,
    vert_to_face_discrete,
    vert_to_face_mean,
)
from geograypher_tpu_torch.ops.onehot import onehot_to_class
from geograypher_tpu_torch.ops.rasterize import (
    RasterConfig,
    bin_all,
    bin_triangles,
    fused_view_class_counts,
    rasterize_setup,
    rasterize_triangles,
    setup_from_soa,
    setup_triangles,
    transform_to_camera,
    tri_to_soa,
)
from geograypher_tpu_torch.parallel import planner as _planner
from geograypher_tpu_torch.utils import cache as p2f_cache
from geograypher_tpu_torch.utils import crs as crs_utils
from geograypher_tpu_torch.utils import geometric
from geograypher_tpu_torch.utils.device import PinnedUpload, resolve_device
from geograypher_tpu_torch.utils.files import ensure_containing_folder
from geograypher_tpu_torch.utils.io import nearest_indices, write_image
from geograypher_tpu_torch.utils.meshio import load_mesh, save_mesh
from geograypher_tpu_torch.utils.parsing import (
    crs_from_srs_text,
    parse_metashape_mesh_metadata,
    parse_transform_metashape,
)
from geograypher_tpu_torch.utils.profiling import annotate
from geograypher_tpu_torch.utils.vector import (
    Polygon,
    VectorData,
    points_near_polygons,
    polygons_from_mask,
    rasterize_polygons,
)
from geograypher_tpu_torch.utils.visualization import save_composite

logger = logging.getLogger(__name__)

DEFAULT_RASTER_CONFIG = RasterConfig(caps=(512, 128, 64, 64))


@dataclasses.dataclass
class OrthoPlan:
    """The cameras of an orthographic render (``TexturedMesh.ortho_plan``).

    ``tri`` (F, 3, 3) float32 triangles centred on the footprint, on the
    mesh's device; ``tiles`` one (first row, first column, world-to-camera
    4x4 float32 tensor) a tile, every tile ``tile_h`` x ``tile_w`` px seen
    at focal length ``focal``; the whole image ``height`` x ``width`` px
    over ``bounds`` (x0, y0, x1, y1) in ``epsg``, pixel (0, 0) top-left.
    """

    tri: torch.Tensor
    tiles: list
    focal: float
    tile_w: int
    tile_h: int
    width: int
    height: int
    bounds: tuple
    epsg: typing.Optional[int]


def _check_batch_size(batch_size: int) -> None:
    """``batch_size`` of the per-view loops: any count >= 1, which the
    loops, as the JAX package's, do not use."""
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")


#: most host threads of a ``save_renders`` call's :class:`_MaskWriter`: a
#: 4K mask's zlib encode takes about six times the main thread's work on
#: the view
MASK_WRITER_MAX_THREADS = 8


class _MaskWriter:
    """The files of :meth:`TexturedMesh.save_renders`, each encoded and
    written by :func:`write_image` on a pool of host threads while the
    main thread renders the next views; the threads get host arrays only.

    The pool takes a thread for each CPU the process may run on but the
    main thread's (1 to :data:`MASK_WRITER_MAX_THREADS`).  At most twice
    as many files are in flight: past that, and before a second write to a
    path still pending (the later view's file stays), the main thread
    waits for the oldest writes under the span ``render.writer_wait``, as
    it does for every write left on exit.  A failed write is raised by the
    wait that meets it, the first in view order, and no write is submitted
    after it; every write submitted has ended, and every thread, when the
    ``with`` block is left.
    """

    def __init__(self):
        cpus = (len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
                else os.cpu_count() or 1)
        self.threads = max(1, min(MASK_WRITER_MAX_THREADS, cpus - 1))
        self._pool = ThreadPoolExecutor(self.threads, thread_name_prefix="mask-writer")
        self._pending = collections.deque()  # (path, future), oldest first

    def failed(self) -> bool:
        """Whether a pending write has failed: submit no more."""
        return any(f.done() and f.exception() is not None for _, f in self._pending)

    def _blocked(self, path) -> bool:
        return (len(self._pending) >= 2 * self.threads
                or any(p == path for p, _ in self._pending))

    def _wait(self, until):
        with annotate("render.writer_wait"):
            while until():
                self._pending.popleft()[1].result()

    def submit(self, path: Path, array: np.ndarray):
        if self._blocked(path):
            self._wait(lambda: self._blocked(path))
        self._pending.append((path, self._pool.submit(write_image, path, array)))

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        try:
            if self._pending:
                self._wait(lambda: self._pending)
        except Exception:
            if exc_type is None:
                raise
        finally:
            self._pool.shutdown()


class TexturedMesh:
    """A triangle mesh in a geospatial frame whose per-view work runs on
    ``device``.

    Vertices are stored float64 on the host, in ECEF (EPSG:4978) when
    georeferenced or in an arbitrary local frame when not.
    """

    def __init__(
        self,
        mesh: typing.Union[PATH_TYPE, tuple, "TexturedMesh"],
        downsample_target: float = 1.0,
        transform_filename: typing.Optional[PATH_TYPE] = None,
        texture: typing.Union[None, PATH_TYPE, np.ndarray] = None,
        texture_column_name: typing.Optional[str] = None,
        CRS: typing.Optional[int] = None,
        ROI=None,
        ROI_buffer_meters: float = 0.0,
        IDs_to_labels: typing.Optional[dict] = None,
        shift: typing.Optional[np.ndarray] = None,
        raster_config: RasterConfig = DEFAULT_RASTER_CONFIG,
        local_to_epsg_4978_transform: typing.Optional[np.ndarray] = None,
        device="cuda",
    ):
        """Load geometry + texture.

        Args:
            mesh: a mesh file (.ply/.obj/.npz), a (verts, faces) tuple, or
                another TexturedMesh to share geometry with.
            downsample_target: fraction of faces to keep (vertex-clustering
                decimation).
            transform_filename: Metashape camera XML providing the
                local -> ECEF transform, or mesh-metadata XML with CRS +
                shift.
            texture: np array (per-vert or per-face), the name of a
                per-vertex scalar of the mesh file, a .npy file or a
                vector file (labels by ``texture_column_name``).
            CRS: EPSG code the mesh vertices are in (None = local frame).
            ROI: vector data / file / Polygon to crop the mesh to.
            shift: (3,) added to the vertices at load.
            device: where per-view work runs: the card ("cuda", the
                default; raises when there is none, never falls back to
                the CPU) or "cpu" when asked for explicitly.
        """
        self.device = resolve_device(device, "TexturedMesh")
        self.raster_config = raster_config
        self.IDs_to_labels = dict(IDs_to_labels) if IDs_to_labels else None
        self.vertex_texture: typing.Optional[np.ndarray] = None
        self.face_texture: typing.Optional[np.ndarray] = None
        self._tri_cache: dict = {}
        self._plan_cache: dict = {}  # AggregationPlan per survey key
        self._local_transform = None  # set when georeferenced
        self._mesh_attrs: dict = {}
        self.distortion_engine = DistortionEngine(self.device)

        if isinstance(mesh, TexturedMesh):
            self.verts = mesh.verts
            self.faces = mesh.faces
            self.CRS = mesh.CRS
            self._local_transform = mesh._local_transform
        elif isinstance(mesh, (tuple, list)):
            verts, faces = mesh
            self.verts = np.asarray(verts, dtype=np.float64)
            self.faces = np.asarray(faces, dtype=np.int32)
            self.CRS = CRS
        else:
            self.verts, self.faces, attrs = load_mesh(mesh)
            self.CRS = CRS
            # named per-vertex scalars, for load_texture's
            # texture-on-the-mesh branch
            self._mesh_attrs = dict(attrs)
            if "colors" in attrs:
                self.vertex_texture = attrs["colors"].astype(np.float64)

        if transform_filename is not None:
            self._apply_transform_file(transform_filename)
        if local_to_epsg_4978_transform is not None:
            self._set_local_transform(np.asarray(local_to_epsg_4978_transform))
        if shift is not None:
            self.verts = self.verts + np.asarray(shift, dtype=np.float64)
        # reproject to the internal ECEF frame when georeferenced
        if self.CRS is not None and self.CRS != EARTH_CENTERED_EARTH_FIXED_EPSG:
            self.verts = crs_utils.transform_points(
                self.verts, self.CRS, EARTH_CENTERED_EARTH_FIXED_EPSG
            )
            self.CRS = EARTH_CENTERED_EARTH_FIXED_EPSG

        if ROI is not None:
            self.select_mesh_ROI(ROI, ROI_buffer_meters, inplace=True)
        if downsample_target < 1.0:
            self.downsample(downsample_target, inplace=True)
        if texture is not None:
            self.load_texture(texture, texture_column_name)

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
            self._set_local_transform(t)
            return
        crs_text, shift = parse_metashape_mesh_metadata(transform_filename)
        epsg = crs_from_srs_text(crs_text)
        if shift is not None:
            self.verts = self.verts + shift
        if epsg is not None:
            self.CRS = epsg

    def _set_local_transform(self, t: np.ndarray):
        self._local_transform = t

    @property
    def n_faces(self) -> int:
        return int(self.faces.shape[0])

    @property
    def n_verts(self) -> int:
        return int(self.verts.shape[0])

    def get_mesh_hash(self) -> str:
        """SHA-256 of the vertex and face arrays: the JAX package's digest
        for the same geometry."""
        hasher = hashlib.sha256()
        hasher.update(np.ascontiguousarray(self.verts).tobytes())
        hasher.update(np.ascontiguousarray(self.faces).tobytes())
        return hasher.hexdigest()

    def _invalidate_geometry_caches(self) -> None:
        """Drop every geometry-derived device cache after a geometry edit
        (crop / sort / downsample): the triangle caches, the plans sized
        from them, and the distortion maps kept beside them."""
        self._tri_cache.clear()
        self._plan_cache.clear()
        self.distortion_engine.clear()

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
        self._invalidate_geometry_caches()
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

    # -- geometry edits ---------------------------------------------------

    def select_mesh_ROI(
        self,
        ROI,
        buffer_meters: float = 0.0,
        inplace: bool = False,
        default_CRS: typing.Optional[int] = None,
    ):
        """Crop to faces whose vertices all fall inside the (buffered) ROI.

        The buffer is an exact distance test
        (:func:`~geograypher_tpu_torch.utils.vector.points_near_polygons`);
        the JAX package buffers on a 2048 x 2048 raster grid, so the two
        may differ on vertices within 2 grid cells of the buffer's edge.
        Returns (mesh, face mask).
        """
        if isinstance(ROI, (str, Path)):
            ROI = VectorData.read_file(ROI)
        elif isinstance(ROI, Polygon):
            ROI = VectorData([ROI], epsg=default_CRS)

        if ROI.epsg is not None and self.CRS is not None:
            ROI = ROI.ensure_projected()
            verts2d = crs_utils.transform_points(self.verts, self.CRS, ROI.epsg)[
                :, :2
            ]
        else:
            verts2d = self.verts[:, :2]
        polys = [g for g in ROI.geometries if isinstance(g, Polygon)]
        inside = points_near_polygons(polys, verts2d, buffer_meters)
        return self._keep_vertices(inside, inplace=inplace)

    def _keep_vertices(self, vert_mask: np.ndarray, inplace: bool):
        keep_face = vert_mask[self.faces].all(axis=1)
        return self._keep_faces(keep_face, inplace=inplace)

    def _derived(self, verts: np.ndarray, faces: np.ndarray) -> "TexturedMesh":
        """A mesh of other geometry with this one's frame, labels, raster
        configuration and device."""
        sub = TexturedMesh(
            (verts, faces),
            CRS=self.CRS,
            IDs_to_labels=self.IDs_to_labels,
            raster_config=self.raster_config,
            device=self.device,
        )
        sub._local_transform = self._local_transform
        return sub

    def _keep_faces(self, face_mask: np.ndarray, inplace: bool):
        new_faces = self.faces[face_mask]
        used = np.zeros(len(self.verts), dtype=bool)
        used[new_faces.reshape(-1)] = True
        remap = np.cumsum(used) - 1
        out_verts = self.verts[used]
        out_faces = remap[new_faces].astype(np.int32)
        if inplace:
            self.verts = out_verts
            self.faces = out_faces
            if self.vertex_texture is not None:
                self.vertex_texture = self.vertex_texture[used]
            if self.face_texture is not None:
                self.face_texture = self.face_texture[face_mask]
            self._invalidate_geometry_caches()
            return self, face_mask
        sub = self._derived(out_verts, out_faces)
        if self.vertex_texture is not None:
            sub.vertex_texture = self.vertex_texture[used]
        if self.face_texture is not None:
            sub.face_texture = self.face_texture[face_mask]
        return sub, face_mask

    def downsample(self, target: float, inplace: bool = False):
        """Vertex-clustering decimation to ~``target`` fraction of faces,
        with KDTree texture transfer."""
        from scipy.spatial import cKDTree

        # cluster cell size from target face ratio: faces ~ verts * 2 on
        # meshes; cell count ~ verts * target
        bbox = self.verts.max(0) - self.verts.min(0)
        vol = np.prod(np.maximum(bbox[:2], 1e-9)) * max(bbox[2], bbox[:2].mean() * 0.01)
        n_cells = max(int(self.n_verts * target), 8)
        cell = (vol / n_cells) ** (1 / 3)
        keys = np.floor((self.verts - self.verts.min(0)) / cell).astype(np.int64)
        _, first_idx, inv = np.unique(
            keys[:, 0] * 73856093 ^ keys[:, 1] * 19349663 ^ keys[:, 2] * 83492791,
            return_index=True,
            return_inverse=True,
        )
        # representative vertex = centroid of cluster
        n_new = first_idx.shape[0]
        sums = np.zeros((n_new, 3))
        np.add.at(sums, inv, self.verts)
        counts = np.bincount(inv, minlength=n_new)
        new_verts = sums / counts[:, None]
        new_faces = inv[self.faces]
        nondegenerate = (
            (new_faces[:, 0] != new_faces[:, 1])
            & (new_faces[:, 1] != new_faces[:, 2])
            & (new_faces[:, 0] != new_faces[:, 2])
        )
        new_faces = new_faces[nondegenerate].astype(np.int32)

        new_vertex_texture = None
        if self.vertex_texture is not None:
            _, nearest = cKDTree(self.verts).query(new_verts)
            new_vertex_texture = self.vertex_texture[nearest]
        if inplace:
            self.verts = new_verts
            self.faces = new_faces
            self.vertex_texture = new_vertex_texture
            self.face_texture = None
            self._invalidate_geometry_caches()
            return self
        sub = self._derived(new_verts, new_faces)
        sub.vertex_texture = new_vertex_texture
        return sub

    # -- textures ----------------------------------------------------------

    def set_texture(
        self,
        texture_array: np.ndarray,
        is_vertex: typing.Optional[bool] = None,
        IDs_to_labels: typing.Optional[dict] = None,
    ):
        """Install a texture, inferring vertex- vs face-alignment by
        length."""
        texture_array = np.asarray(texture_array, dtype=np.float64)
        if texture_array.ndim == 1:
            texture_array = texture_array[:, None]
        if is_vertex is None:
            if texture_array.shape[0] == self.n_verts:
                is_vertex = True
            elif texture_array.shape[0] == self.n_faces:
                is_vertex = False
            else:
                raise ValueError(
                    f"Texture length {texture_array.shape[0]} matches neither "
                    f"verts ({self.n_verts}) nor faces ({self.n_faces})"
                )
        if is_vertex:
            self.vertex_texture = texture_array
            self.face_texture = None
        else:
            self.face_texture = texture_array
            self.vertex_texture = None
        if IDs_to_labels is not None:
            self.IDs_to_labels = dict(IDs_to_labels)

    def _on_device(self, array: np.ndarray, dtype) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(array)).to(self.device, dtype)

    def get_texture(
        self,
        request_vertex_texture: typing.Optional[bool] = None,
        try_verts_faces_conversion: bool = True,
    ) -> typing.Optional[np.ndarray]:
        """Fetch the texture in the requested alignment, converting (on the
        mesh's device, in float32) if allowed."""
        if request_vertex_texture is None:
            return (
                self.vertex_texture
                if self.vertex_texture is not None
                else self.face_texture
            )
        if request_vertex_texture:
            if self.vertex_texture is not None:
                return self.vertex_texture
            if self.face_texture is not None and try_verts_faces_conversion:
                return face_to_vert_texture(
                    self._on_device(self.faces, torch.int64),
                    self._on_device(self.face_texture, torch.float32),
                    self.n_verts,
                ).cpu().numpy()
            return None
        if self.face_texture is not None:
            return self.face_texture
        if self.vertex_texture is not None and try_verts_faces_conversion:
            return self.vert_to_face_texture()
        return None

    def vert_to_face_texture(self) -> np.ndarray:
        """Vertex texture -> face texture: mode vote for discrete data,
        mean otherwise."""
        if self.vertex_texture is None:
            raise ValueError("No vertex texture")
        tex = self.vertex_texture
        faces = self._on_device(self.faces, torch.int64)
        if self.is_discrete_texture(tex):
            finite = tex[np.isfinite(tex[:, 0]), 0]
            n_classes = int(finite.max()) + 1 if finite.size else 1
            out = vert_to_face_discrete(
                faces, self._on_device(tex[:, 0], torch.float32), n_classes
            )[:, None]
        else:
            out = vert_to_face_mean(faces, self._on_device(tex, torch.float32))
        return out.cpu().numpy().astype(np.float64)

    @staticmethod
    def is_discrete_texture(tex: np.ndarray) -> bool:
        finite = tex[np.isfinite(tex)]
        return finite.size == 0 or bool(
            np.allclose(finite, np.round(finite))
        )

    def load_texture(
        self,
        texture: typing.Union[PATH_TYPE, np.ndarray],
        texture_column_name: typing.Optional[str] = None,
    ):
        """Texture loading chain: array -> named mesh scalar -> .npy ->
        vector file -> raster (GeoTIFF) file, sampled at each vertex."""
        if isinstance(texture, np.ndarray):
            self.set_texture(texture)
            return
        # a named per-vertex scalar already on the mesh (a PLY property)
        if str(texture) in self._mesh_attrs:
            vals = np.asarray(self._mesh_attrs[str(texture)], dtype=np.float64)
            self.set_texture(vals, is_vertex=vals.shape[0] == self.n_verts)
            return
        path = Path(texture)
        suffix = path.suffix.lower()
        if suffix == ".npy":
            self.set_texture(np.load(path))
        elif suffix in (".geojson", ".json", ".gpkg", ".shp"):
            labels, ids_to_labels = self.get_values_for_verts_from_vector(
                path, texture_column_name
            )
            self.set_texture(labels, is_vertex=True, IDs_to_labels=ids_to_labels)
        elif suffix in (".tif", ".tiff"):
            self.set_texture(self.get_values_for_verts_from_raster(path),
                             is_vertex=True)
        else:
            raise ValueError(f"Cannot load texture from {path}")

    def remap_texture(self, labels_to_IDs: dict):
        """String/label texture values -> integer IDs.

        Textures are stored numerically (set_texture coerces to float),
        so string labels resolve through the mesh's current
        ``IDs_to_labels`` mapping (texture id -> label -> new ID);
        numeric keys match texture values directly.
        """
        tex = self.get_texture()
        out = np.full_like(tex, np.nan, dtype=np.float64)
        if any(isinstance(k, str) for k in labels_to_IDs):
            if not self.IDs_to_labels:
                raise ValueError(
                    "remap_texture got string labels but the mesh has no "
                    "IDs_to_labels mapping to resolve them against"
                )
            for old_id, label in self.IDs_to_labels.items():
                if label in labels_to_IDs:
                    out[tex == float(old_id)] = labels_to_IDs[label]
        else:
            for label, ID in labels_to_IDs.items():
                out[tex == label] = ID
        self.set_texture(out)
        self.IDs_to_labels = {v: k for k, v in labels_to_IDs.items()}

    # -- geospatial sampling ------------------------------------------------

    def get_verts_vector(self, crs: typing.Optional[int] = None) -> VectorData:
        """Vertices as a point VectorData."""
        if crs is None and self.CRS is not None:
            crs = self.get_working_projected_CRS()
        verts = self.get_vertices_in_CRS(crs)
        if crs == 4326:
            pts = [np.array([v[1], v[0]]) for v in verts]  # lon, lat
        else:
            pts = [v[:2].copy() for v in verts]
        return VectorData(pts, {"vert_ID": list(range(len(pts)))}, epsg=crs)

    def get_values_for_verts_from_vector(
        self,
        vector: typing.Union[PATH_TYPE, VectorData],
        column_name: typing.Optional[str] = None,
    ):
        """Per-vertex class from polygon containment: (ids (V,) float with
        NaN outside every polygon, ids_to_labels)."""
        if not isinstance(vector, VectorData):
            vector = VectorData.read_file(vector)
        if self.CRS is not None and vector.epsg is not None:
            vector = vector.ensure_projected()
            verts2d = crs_utils.transform_points(
                self.verts, self.CRS, vector.epsg
            )[:, :2]
        else:
            verts2d = self.verts[:, :2]
        poly_idx = vector.contains_points(verts2d)

        if column_name is not None and column_name in vector.attributes:
            col = vector.attributes[column_name]
            classes = sorted({v for v in col if v is not None}, key=str)
            label_to_id = {c: i for i, c in enumerate(classes)}
            ids = np.full(len(verts2d), np.nan)
            hit = poly_idx >= 0
            ids[hit] = [
                label_to_id.get(col[i], np.nan) for i in poly_idx[hit]
            ]
            ids_to_labels = {i: c for c, i in label_to_id.items()}
            return ids, ids_to_labels
        ids = np.where(poly_idx >= 0, poly_idx.astype(float), np.nan)
        return ids, {i: i for i in range(len(vector))}

    def get_values_for_verts_from_raster(
        self, raster_file: PATH_TYPE, method: str = "nearest"
    ) -> np.ndarray:
        """Sample a georeferenced raster at each vertex (reference
        meshes.py:1425-1472), in the raster's CRS (the mesh's when the
        raster has none); NaN outside it and on nodata."""
        from geograypher_tpu_torch.utils.raster import read_geotiff

        raster = read_geotiff(raster_file)
        epsg = raster.epsg if raster.epsg is not None else self.CRS
        verts = self.get_vertices_in_CRS(epsg)
        if epsg == LAT_LON_EPSG:
            xs, ys = verts[:, 1], verts[:, 0]  # lon, lat
        else:
            xs, ys = verts[:, 0], verts[:, 1]
        return raster.sample(xs, ys, method=method)

    def get_height_above_ground(
        self, DTM_file: PATH_TYPE, threshold: typing.Optional[float] = None
    ) -> np.ndarray:
        """Per-vertex height above a digital terrain model (reference
        meshes.py:1474-1502): the vertex's ellipsoidal altitude less the
        DTM's height under it; with ``threshold`` the bool mask of the
        vertices lower than it."""
        dtm_heights = self.get_values_for_verts_from_raster(DTM_file)
        if dtm_heights.ndim > 1:
            dtm_heights = dtm_heights[..., 0]
        vert_alt = crs_utils.transform_points(
            self.verts, self.CRS, LAT_LON_EPSG
        )[:, 2]
        hag = vert_alt - dtm_heights
        if threshold is not None:
            return hag < threshold
        return hag

    def label_ground_class(
        self,
        DTM_file: PATH_TYPE,
        height_above_ground_threshold: float = 2.0,
        labels: typing.Optional[np.ndarray] = None,
        only_label_existing_labels: typing.Optional[bool] = None,
        ground_class_name: str = "ground",
        ground_ID: typing.Optional[int] = None,
        set_mesh_texture: bool = True,
        only_label_existing: typing.Optional[bool] = None,
    ):
        """Relabel near-ground vertices (or faces) to the ground class
        (reference meshes.py:1504-1596).

        ``labels`` may be a vertex- or face-aligned array to relabel;
        when omitted the mesh's vertex texture is used (and
        ``set_mesh_texture`` installs the result).  A face is ground when
        at least half of its vertices are.  ``only_label_existing`` is an
        alias of ``only_label_existing_labels``.  Returns ``(labels,
        ground_ID)``.
        """
        if only_label_existing_labels is None:
            only_label_existing_labels = (
                True if only_label_existing is None else only_label_existing
            )
        use_vertex = True
        if labels is not None:
            labels = np.asarray(labels, dtype=np.float64)
            if labels.ndim == 1:
                labels = labels[:, None]
            if labels.shape[0] == self.n_verts:
                use_vertex = True
            elif labels.shape[0] == self.n_faces:
                use_vertex = False
            else:
                raise ValueError(
                    "labels match neither the vertex nor the face count"
                )
            labels = labels.copy()
        else:
            tex = self.get_texture(request_vertex_texture=True)
            labels = (
                np.full((self.n_verts, 1), np.nan) if tex is None
                else tex.copy()
            )
        ground = self.get_height_above_ground(
            DTM_file, threshold=height_above_ground_threshold
        )
        if not use_vertex:
            # majority vote of the face's vertices
            ground = ground[self.faces].mean(axis=1) >= 0.5
        mask = ground.copy()
        if only_label_existing_labels:
            mask &= np.isfinite(labels[:, 0])
        if ground_ID is None:
            ids = self.IDs_to_labels or {}
            labels_to_ids = {v: k for k, v in ids.items()}
            if ground_class_name in labels_to_ids:
                ground_ID = labels_to_ids[ground_class_name]
            else:
                finite = labels[np.isfinite(labels)]
                ground_ID = int(finite.max()) + 1 if finite.size else 0
        labels[mask, 0] = ground_ID
        if set_mesh_texture and use_vertex:
            ids = dict(self.IDs_to_labels or {})
            if np.isfinite(ground_ID):
                ids[ground_ID] = ground_class_name
            self.set_texture(labels, is_vertex=True, IDs_to_labels=ids)
        return labels, ground_ID

    def get_face_area_ratios(self) -> np.ndarray:
        """Per-face (2D z-projected area) / (3D area) in the working
        projected CRS: ~1 for flat ground, ->0 for steep faces (reference
        meshes.py:881-911); 0 for degenerate faces."""
        from geograypher_tpu_torch.utils.numeric import (
            compute_3D_triangle_area_vectorized,
        )

        crs = self.get_working_projected_CRS() if self.CRS is not None else None
        verts = self.get_vertices_in_CRS(crs) if crs else self.verts
        corners = verts[self.faces].transpose(1, 0, 2)  # (3, F, 3)
        area3d, area2d = compute_3D_triangle_area_vectorized(corners)
        with np.errstate(invalid="ignore", divide="ignore"):
            ratio = area2d / area3d
        return np.nan_to_num(ratio, nan=0.0)

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

    def _distortion_map_device(
        self, cameras: CameraSet, index: int, image_scale: float
    ) -> typing.Optional[torch.Tensor]:
        """The warped->ideal sampling map of a camera's sensor on the
        mesh's device (None when the sensor is undistorted); built once
        per sensor and scale and kept by the distortion engine."""
        sensor = cameras.sensors[cameras.sensor_IDs[index]]
        dist = sensor.get("distortion_params") or {}
        if not dist:
            return None
        _, w2i = self.distortion_engine.get_maps(
            sensor["f"],
            sensor.get("cx", 0.0),
            sensor.get("cy", 0.0),
            sensor["image_width"],
            sensor["image_height"],
            distortion_dict_to_vector(dist),
            image_scale,
        )
        return w2i

    def _rasterize_view(self, cameras, index, scale, apply_distortion, config):
        """One view's pix2face on the device and its overflow: the pinhole
        render and, for a distorted sensor, its nearest-neighbour remap
        into the real image's geometry."""
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
        if self._resolve_distortion(cameras, index, apply_distortion):
            w2i = self._distortion_map_device(cameras, index, scale)
            if w2i is not None:
                p2f = remap_image_torch(p2f, w2i, fill_value=-1)
        return p2f, binned.overflow

    @staticmethod
    def _raise_on_overflow(overflow) -> None:
        worst = int(overflow)
        if worst:
            raise RuntimeError(
                f"raster capacity overflow: a view dropped {worst} candidate "
                "entries, so its pix2face is incomplete. Pass a RasterConfig "
                "with larger caps."
            )

    def _pix2face_device(
        self,
        cameras: CameraSet,
        index: int,
        render_img_scale: float = 1.0,
        apply_distortion: typing.Optional[bool] = None,
        config: typing.Optional[RasterConfig] = None,
        save_to_cache: bool = False,
        cache_folder: typing.Optional[PATH_TYPE] = None,
    ) -> torch.Tensor:
        """One camera's pix2face as a tensor on the mesh's device;
        distortion warping runs there too (default: whenever the sensor
        is calibrated with distortion).  With caching requested,
        delegates to the host-side cached path.  Raises if the view's
        tile lists dropped candidates."""
        if save_to_cache:
            return torch.as_tensor(
                self.pix2face(
                    cameras, [index], render_img_scale=render_img_scale,
                    apply_distortion=apply_distortion, config=config,
                    save_to_cache=True, cache_folder=cache_folder,
                )[0]
            ).to(self.device)
        p2f, overflow = self._rasterize_view(
            cameras, index, render_img_scale, apply_distortion,
            config or self.raster_config,
        )
        self._raise_on_overflow(overflow)
        return p2f

    def pix2face(
        self,
        cameras: CameraSet,
        indices: typing.Optional[typing.Sequence[int]] = None,
        render_img_scale: float = 1.0,
        apply_distortion: typing.Optional[bool] = None,
        config: typing.Optional[RasterConfig] = None,
        save_to_cache: bool = False,
        cache_folder: typing.Optional[PATH_TYPE] = None,
    ) -> np.ndarray:
        """(N, H, W) int32 pixel -> face-id maps for the given cameras, -1
        where no face is seen.

        ``apply_distortion=None`` (the default) warps whenever the sensor
        carries distortion parameters; True/False force it.  The warp maps
        the pinhole render to the real (distorted) image geometry with
        nearest-neighbor resampling.  ``save_to_cache`` persists maps
        run-length coded, keyed by (mesh hash, camera hash, scale,
        distortion flag, config).  Raises after the last view if any
        view's tile lists dropped candidates; such a map is never cached.
        """
        config = config or self.raster_config
        if indices is None:
            indices = list(range(len(cameras)))
        if save_to_cache:
            cache_folder = cache_folder or CACHE_FOLDER
            mesh_hash = self.get_mesh_hash()
        out = []
        worst = 0
        for i in indices:
            distort_i = self._resolve_distortion(cameras, i, apply_distortion)
            if save_to_cache:
                cam_hash = cameras.get_subset_cameras([i]).get_camera_hash()
                # the config is part of the key: maps rendered under other
                # capacities must not be reused after the user raises caps
                cache_key = [
                    mesh_hash, cam_hash, render_img_scale, distort_i,
                    repr(config),
                ]
                cached = p2f_cache.load_pix2face(
                    "pix2face", cache_key, cache_folder
                )
                if cached is not None:
                    out.append(cached)
                    continue
            p2f, overflow = self._rasterize_view(
                cameras, i, render_img_scale, distort_i, config
            )
            p2f = p2f.cpu().numpy()
            worst = max(worst, int(overflow))
            if save_to_cache and not int(overflow):
                p2f_cache.save_pix2face(p2f, "pix2face", cache_key, cache_folder)
            out.append(p2f)
        self._raise_on_overflow(worst)
        return np.stack(out, axis=0)

    def _render_flat_device(self, cameras, render_img_scale, pix2face_kwargs):
        """Per camera ``(image, overflow)``: the (H, W, C) float32 rendered
        texture image on the mesh's device and the candidates its tile
        lists dropped (a () tensor on the device; the image is incomplete
        when it is not 0).  Raises nothing on overflow: the callers do."""
        face_tex = self.get_texture(
            request_vertex_texture=False, try_verts_faces_conversion=True
        )
        if face_tex is None:
            raise ValueError("Mesh has no texture to render")
        tex_dev = self._on_device(face_tex, torch.float32)
        config = pix2face_kwargs.get("config") or self.raster_config
        apply_distortion = pix2face_kwargs.get("apply_distortion")
        for i in range(len(cameras)):
            with annotate("render.view"):
                if pix2face_kwargs.get("save_to_cache"):
                    # the cached path raises on an overflowing view itself
                    p2f = self._pix2face_device(
                        cameras, i, render_img_scale=render_img_scale,
                        **pix2face_kwargs,
                    )
                    overflow = torch.zeros((), dtype=torch.int64,
                                           device=self.device)
                else:
                    p2f, overflow = self._rasterize_view(
                        cameras, i, render_img_scale, apply_distortion, config
                    )
                image = render_texture(p2f, tex_dev)
            yield image, overflow

    def render_flat(
        self,
        cameras: CameraSet,
        batch_size: int = 1,
        render_img_scale: float = 1.0,
        return_camera: bool = False,
        **pix2face_kwargs,
    ):
        """Generator of per-camera rendered texture images, (H, W, C)
        float32 numpy, NaN where no face is seen (and where the face has
        no label).  ``pix2face_kwargs``: ``apply_distortion``, ``config``,
        ``save_to_cache``, ``cache_folder``.  ``batch_size`` (>= 1) is
        accepted and, as in the JAX package, changes nothing: views run one
        at a time.  Raises after the last view if any view's tile lists
        dropped candidates."""
        _check_batch_size(batch_size)
        worst = torch.zeros((), dtype=torch.int64, device=self.device)
        for i, (img, overflow) in enumerate(self._render_flat_device(
                cameras, render_img_scale, pix2face_kwargs)):
            worst = torch.maximum(worst, overflow)
            img = img.cpu().numpy()
            if return_camera:
                yield img, cameras.get_subset_cameras([i])
            else:
                yield img
        self._raise_on_overflow(worst)

    @staticmethod
    def _one_hot_scan(upload: PinnedUpload, img):
        """``(image, image on the device, class image or None)``: the image
        uploaded once (float64 as it is, every other dtype as float32) and
        scanned where it lies by
        :func:`~geograypher_tpu_torch.ops.onehot.onehot_to_class`; the
        class image is None unless the image is an exact one-hot stack
        (one 4-byte read-back decides)."""
        img = np.asarray(img)
        if img.dtype not in (np.float32, np.float64):
            # exact for 0 and 1, and no other value becomes 0 or 1
            img = img.astype(np.float32)
        img_dev = upload(img)
        if img.ndim != 3 or img.shape[-1] < 2:
            return img, img_dev, None
        cls, violations = onehot_to_class(img_dev)
        return img, img_dev, (None if int(violations) else cls)

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
        images keep per-channel means over the view's pix2face (for a
        distorted sensor the pinhole render remapped into its geometry).  After
        the last view it raises if any view's tile lists dropped
        candidates.  ``batch_size`` (>= 1) is accepted and, as in the JAX
        package, changes nothing: views run one at a time.
        """
        _check_batch_size(batch_size)
        config = pix2face_kwargs.get("config") or self.raster_config
        apply_distortion = pix2face_kwargs.get("apply_distortion")
        overflow = torch.zeros((), dtype=torch.int64, device=self.device)
        upload = PinnedUpload(self.device)
        for i in range(len(cameras)):
            img = cameras.get_image_by_index(i, aggregate_img_scale)
            if check_null_image and not np.any(np.isfinite(img)):
                yield None
                continue
            img, img_dev, cls = self._one_hot_scan(upload, img)
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

    # route aggregate_projected_images to the planner from this many label
    # pixels over the survey's views on (4 views at 4K): the census costs
    # a view's setup and binning once more
    _PLANNED_MIN_PIXELS = 32 * 1024 * 1024

    def aggregate_projected_images(
        self,
        cameras: CameraSet,
        batch_size: int = 1,
        aggregate_img_scale: float = 1.0,
        return_all: bool = False,
        use_planned="auto",
        **kwargs,
    ):
        """Average projections across views.

        ``use_planned``: serve the call through the census-bucketed
        planner (:meth:`aggregate_projected_images_planned`, the same
        view-weighted semantics) when every view is an exact one-hot class
        stack.  ``"auto"`` (default) routes surveys past
        ``_PLANNED_MIN_PIXELS`` label pixels; ``True`` forces it (raises
        ``ValueError`` with the reason when it cannot); ``False``, and
        ``return_all=True``, keep the per-view streaming loop, which raises
        after the last view if a view's tile lists dropped candidates.

        ``batch_size`` (>= 1) changes nothing, as in the JAX package.
        Returns (average_projections (F, C) numpy, additional_information
        dict).
        """
        _check_batch_size(batch_size)
        if use_planned is not False and not return_all:
            routed = self._route_projected_planned(
                cameras, aggregate_img_scale, kwargs,
                strict=(use_planned is True),
            )
            if routed is not None:
                return routed
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

    def _route_projected_planned(
        self, cameras, aggregate_img_scale: float, kwargs: dict,
        strict: bool,
    ):
        """Try to serve :meth:`aggregate_projected_images` through the
        planned weighted path; return its (avg, additional), or None with
        the reason logged (raised as ``ValueError`` when ``strict``).

        Each view's image is read and uploaded once and scanned on the
        device; its class image comes back to the host as int8 (int32 past
        127 classes), so the planner and its retry never touch the float
        stack again.  A view the scan refuses sends the call down the
        streaming path.
        """
        reason = None
        extra = set(kwargs) - {"config", "apply_distortion"}
        labels, n_classes = None, None
        if extra:
            reason = f"unsupported project_images kwargs {sorted(extra)}"
        else:
            batch = cameras.get_camera_batch(
                image_scale=aggregate_img_scale, device="cpu")
            h, w = batch.image_height, batch.image_width
            px = len(cameras) * h * w
            if not strict and px < self._PLANNED_MIN_PIXELS:
                reason = (
                    f"survey too small to amortize planning "
                    f"({px} label pixels < {self._PLANNED_MIN_PIXELS})"
                )
        if reason is None:
            upload = PinnedUpload(self.device)
            for i in range(len(cameras)):
                img, _, cls = self._one_hot_scan(
                    upload, cameras.get_image_by_index(i, aggregate_img_scale))
                if cls is None:
                    reason = f"view {i} is not an exact one-hot class stack"
                    break
                if n_classes is None:
                    n_classes = img.shape[-1]
                    labels = np.empty((len(cameras), h, w),
                                      _planner.label_dtype(n_classes))
                elif img.shape[-1] != n_classes:
                    reason = f"view {i} channel count changed"
                    break
                if tuple(cls.shape) != (h, w):
                    reason = f"view {i} image size differs from the batch"
                    break
                # classes are in [-1, n_classes): the cast cannot wrap
                labels[i] = cls.to(torch.int8 if labels.dtype == np.int8
                                   else torch.int32).cpu().numpy()
        if reason is not None:
            if strict:
                raise ValueError(
                    f"use_planned=True but the planned path cannot serve "
                    f"this call: {reason}"
                )
            logger.info("aggregate_projected_images: streaming (%s)", reason)
            return None
        logger.info(
            "aggregate_projected_images: routing %d views through the "
            "planned weighted path", len(cameras),
        )
        return self.aggregate_projected_images_planned(
            cameras, n_classes,
            aggregate_img_scale=aggregate_img_scale,
            config=kwargs.get("config"),
            apply_distortion=kwargs.get("apply_distortion"),
            labels=labels,
        )

    def aggregate_class_images_planned(
        self,
        cameras: CameraSet,
        n_classes: int,
        class_image_provider: typing.Optional[
            typing.Callable[[int], np.ndarray]
        ] = None,
        aggregate_img_scale: float = 1.0,
        config: typing.Optional[RasterConfig] = None,
        apply_distortion: typing.Optional[bool] = None,
        max_buckets: int = 4,
        group: int = 20,
        census_sample: typing.Optional[int] = None,
        label_index=None,
        labels=None,
    ):
        """Census-bucketed POOLED pixel-count aggregation: the sum over
        views of per-face per-class pixel counts.

        Views are censused one by one, bucketed by rounded caps, and run
        with their bucket's caps (``parallel/planner.py``); a view that
        overflows them adds nothing and is re-censused and re-run, never
        raised after partial work.  The plan is cached on the mesh per
        (config, lens rule, image size, buckets, sample, cameras), in the
        cache the survey pipeline shares.

        Args:
            labels: optional (M, H, W) integer class stack, numpy or a
                tensor.  Defaults to ``class_image_provider(i)`` (or the
                argmax of every view's image, -1 where a row is not
                finite) for every view; ``label_index`` maps view id ->
                row of ``labels`` when views share label images.

        Returns (counts (n_faces, n_classes) float32 numpy,
        :class:`~geograypher_tpu_torch.parallel.planner.AggregationPlan`).
        """
        tri_soa, params, labels, h, w, use_dist, plan, config = (
            self._planned_inputs(
                cameras, n_classes, class_image_provider, aggregate_img_scale,
                config, apply_distortion, max_buckets, census_sample, labels,
            )
        )
        counts, plan = _planner.aggregate_counts_planned(
            tri_soa, params, labels, config, h, w, tri_soa.shape[1], n_classes,
            group=group, plan=plan, label_index=label_index,
        )
        return counts[: self.n_faces], plan

    def _survey_plan(self, cameras, tri_soa, params, config, h, w, use_dist,
                     max_buckets=4, census_sample=None):
        """``(plan, whether it was planned now)``: a survey's
        :class:`~geograypher_tpu_torch.parallel.planner.AggregationPlan`
        from the mesh's one plan cache, keyed on everything that decides
        it, and planned and cached when absent."""
        key = (config, use_dist, w, h, max_buckets, census_sample,
               cameras.get_camera_hash())
        plan = self._plan_cache.get(key)
        if plan is not None:
            return plan, False
        plan = self._plan_cache[key] = _planner.plan_aggregation(
            tri_soa, params, config, h, w, tri_soa.shape[1], use_dist=use_dist,
            max_buckets=max_buckets, census_sample=census_sample)
        return plan, True

    def _planned_inputs(
        self, cameras, n_classes, class_image_provider, aggregate_img_scale,
        config, apply_distortion, max_buckets, census_sample, labels,
    ):
        """Shared prep of the planned paths: the triangles (padded to
        ``bin_block`` as the streaming path pads them), packed view
        parameters, the class-image stack, the plan (from the mesh's
        cache) and the config."""
        config = config or self.raster_config
        batch = cameras.get_camera_batch(image_scale=aggregate_img_scale,
                                         device="cpu")
        h, w = batch.image_height, batch.image_width
        n = len(cameras)
        use_dist = _planner.survey_use_dist(batch, apply_distortion)
        tri_soa = self._tri_soa_device(cameras, config.bin_block)
        params = _planner.pack_camera_batch(batch, np.ones(n, np.float32))
        if labels is None:
            if class_image_provider is None:
                class_image_provider = _planner.default_class_image_provider(
                    cameras, aggregate_img_scale)
            labels = np.empty((n, h, w), _planner.label_dtype(n_classes))
            for i in range(n):
                labels[i] = _planner.as_label_dtype(class_image_provider(i),
                                                    n_classes)
        plan, _ = self._survey_plan(cameras, tri_soa, params, config, h, w,
                                    use_dist, max_buckets, census_sample)
        return tri_soa, params, labels, h, w, use_dist, plan, config

    def aggregate_projected_images_planned(
        self,
        cameras: CameraSet,
        n_classes: int,
        class_image_provider: typing.Optional[
            typing.Callable[[int], np.ndarray]
        ] = None,
        aggregate_img_scale: float = 1.0,
        config: typing.Optional[RasterConfig] = None,
        apply_distortion: typing.Optional[bool] = None,
        max_buckets: int = 4,
        group: int = 20,
        census_sample: typing.Optional[int] = None,
        label_index=None,
        labels=None,
    ):
        """Census-bucketed VIEW-WEIGHTED aggregation: per view the per-face
        class distribution (counts / total), averaged over the views that
        saw the face, as :meth:`aggregate_projected_images` computes it;
        arguments as :meth:`aggregate_class_images_planned`.

        Returns ``(average_projections (n_faces, n_classes) with NaN on
        unseen faces, additional_information dict)`` with the keys of
        :meth:`aggregate_projected_images` and ``"plan"``.
        """
        tri_soa, params, labels, h, w, use_dist, plan, config = (
            self._planned_inputs(
                cameras, n_classes, class_image_provider, aggregate_img_scale,
                config, apply_distortion, max_buckets, census_sample, labels,
            )
        )
        value_sum, view_count, plan = _planner.aggregate_projected_planned(
            tri_soa, params, labels, config, h, w, tri_soa.shape[1], n_classes,
            group=group, plan=plan, label_index=label_index,
        )
        value_sum = value_sum[: self.n_faces]
        view_count = view_count[: self.n_faces]
        with np.errstate(invalid="ignore"):
            avg = np.where(
                view_count[:, None] > 0,
                value_sum / np.maximum(view_count, 1.0)[:, None],
                np.nan,
            )
        additional = {
            "projection_counts": view_count,
            "summed_projections": value_sum,
            "plan": plan,
        }
        return avg, additional

    # -- saving ---------------------------------------------------------------

    def save_renders(
        self,
        cameras: CameraSet,
        render_image_scale: float = 1.0,
        output_folder: PATH_TYPE = "renders",
        make_composites: bool = False,
        save_native_resolution: bool = True,
        cast_to_uint8: bool = True,
        output_extension: str = ".png",
        **render_kwargs,
    ):
        """Render per-camera label masks to disk, one file per camera named
        after its image.

        A mask is the rendered texture with NaN -> 255, clipped to 0..255
        and cast to uint8; the cast and, with ``save_native_resolution``
        at a ``render_image_scale`` other than 1, the nearest-neighbour
        resize back to the sensor's size run on the mesh's device, so a
        quarter of the bytes is downloaded.  The files hold what the JAX
        package's hold, a 3-channel texture in cv2's channel order (the
        texture's channels reversed) included.  ``output_extension=".npy"``
        saves the float32 render itself.

        A view whose tile lists dropped candidates writes no file (its
        overflow is read before the write); after the last view the call
        raises naming those views.  With ``make_composites`` each view
        whose image exists also gets ``<stem>_composite.png`` (the PNG
        files only): the float render (unlabelled NaN) against the raw
        image, resized bilinearly to the render where the sizes differ
        (:func:`~geograypher_tpu_torch.utils.visualization.save_composite`).

        The files are encoded and written by :class:`_MaskWriter`'s host
        threads while the next views render; the call returns once every
        file is on disk, and raises the first failed write in view order.
        """
        if output_extension != ".npy" and not cast_to_uint8:
            raise ValueError(
                "an image file takes the uint8 mask: pass cast_to_uint8=True, "
                "or output_extension='.npy' for the float render"
            )
        output_folder = Path(output_folder)
        renders = self._render_flat_device(cameras, render_image_scale, render_kwargs)
        overflowed = []
        with _MaskWriter() as writer:
            for i, (img, overflow) in enumerate(renders):
                if writer.failed():
                    break  # the exit raises it
                with annotate("render.overflow_read"):
                    dropped = int(overflow)
                if dropped:
                    overflowed.append(i)
                    continue
                fname = cameras.image_filenames[i]
                rel = Path(fname.name if fname is not None else "render")
                out_path = (output_folder / rel).with_suffix(output_extension)
                ensure_containing_folder(out_path)
                data = img[..., 0] if img.shape[-1] == 1 else img
                if save_native_resolution and render_image_scale != 1.0:
                    sensor = cameras.sensors[cameras.sensor_IDs[i]]
                    rows = torch.as_tensor(nearest_indices(
                        data.shape[0], sensor["image_height"]), device=self.device)
                    cols = torch.as_tensor(nearest_indices(
                        data.shape[1], sensor["image_width"]), device=self.device)
                    data = data[rows[:, None], cols[None, :]]
                with annotate("render.download"):
                    if output_extension == ".npy":
                        mask = data.cpu().numpy()
                    else:
                        mask = torch.where(torch.isfinite(data), data, 255.0)
                        mask = mask.clamp(0, 255).to(torch.uint8)
                        if mask.ndim == 3 and mask.shape[-1] in (3, 4):
                            mask = mask[..., [2, 1, 0, 3][: mask.shape[-1]]]
                        mask = mask.cpu().numpy()
                writer.submit(out_path, mask)
                if (make_composites and output_extension != ".npy"
                        and fname is not None and Path(fname).exists()):
                    save_composite(data.cpu().numpy(), fname,
                                   out_path.with_name(out_path.stem + "_composite.png"),
                                   self.IDs_to_labels)
        if overflowed:
            raise RuntimeError(
                f"raster capacity overflow in views {overflowed}: their tile "
                "lists dropped candidates, so no file was written for them. "
                "Pass a RasterConfig with larger caps."
            )

    # -- orthographic raster, vector export, polygon labelling -----------------

    def ortho_plan(
        self,
        crs: typing.Optional[int] = None,
        resolution_m: float = 0.2,
        max_pixels: int = 8192,
        max_total_pixels: int = 2 ** 28,
    ) -> "OrthoPlan":
        """The cameras of :meth:`ortho_pix2face`: the footprint's pixel
        grid at ``resolution_m`` (clamped, with a warning, past
        ``max_total_pixels``) and one nadir camera a tile, the footprint
        cut into equal tiles of at most ``max_pixels`` a side.  The
        triangles, centred on the footprint, go to the mesh's device."""
        if crs is None and self.CRS is not None:
            crs = self.get_working_projected_CRS()
        verts = self.get_vertices_in_CRS(crs)
        x0, y0 = verts[:, 0].min(), verts[:, 1].min()
        x1, y1 = verts[:, 0].max(), verts[:, 1].max()
        zmax = verts[:, 2].max()
        span_x = max(x1 - x0, resolution_m)
        span_y = max(y1 - y0, resolution_m)
        # one ground resolution for both axes: the camera has one focal
        # length, so the rendered pixel is square
        res = resolution_m
        if (span_x / res) * (span_y / res) > max_total_pixels:
            res = res * np.sqrt((span_x / res) * (span_y / res) / max_total_pixels)
            logger.warning(
                "ortho_pix2face: %.3g m/px over this footprint needs %.2g "
                "pixels (> max_total_pixels=%d); EFFECTIVE RESOLUTION "
                "DEGRADED to %.3g m/px -- raise max_total_pixels to keep "
                "the requested resolution",
                resolution_m, (span_x / resolution_m) * (span_y / resolution_m),
                max_total_pixels, res,
            )
        w = max(int(np.ceil(span_x / res)), 1)
        h = max(int(np.ceil(span_y / res)), 1)
        cx, cy = (x0 + x1) / 2.0, (y0 + y1) / 2.0
        depth_range = zmax - verts[:, 2].min()
        x_left = cx - w * res / 2.0
        y_top = cy + h * res / 2.0
        if w <= max_pixels and h <= max_pixels:
            tw, th, origins = w, h, [(0, 0, 0.0, 0.0)]
        else:
            tiles_x, tiles_y = -(-w // max_pixels), -(-h // max_pixels)
            tw, th = -(-w // tiles_x), -(-h // tiles_y)
            logger.info(
                "ortho_pix2face: tiling %dx%d px footprint into %dx%d "
                "tiles of %dx%d at the full %.3g m/px",
                w, h, tiles_x, tiles_y, tw, th, res,
            )
            origins = [
                (ti * th, tj * tw,
                 (x_left + (tj * tw + tw / 2.0) * res) - cx,
                 (y_top - (ti * th + th / 2.0) * res) - cy)
                for ti in range(tiles_y) for tj in range(tiles_x)
            ]
        # a nadir camera far above the (sub-)scene: distance D, f = D / res
        dist = max(tw * res, th * res, depth_range, 1e-6) * 40.0
        tiles = []
        for i0, j0, dx, dy in origins:
            c2w = np.array([
                [1.0, 0.0, 0.0, dx],
                [0.0, -1.0, 0.0, dy],
                [0.0, 0.0, -1.0, zmax + dist],
                [0.0, 0.0, 0.0, 1.0],
            ])
            tiles.append((i0, j0, torch.as_tensor(
                np.linalg.inv(c2w), dtype=torch.float32, device=self.device)))
        tri = torch.as_tensor(verts[self.faces] - np.array([[cx, cy, 0.0]]),
                              dtype=torch.float32, device=self.device)
        bounds = (x_left, cy - h * res / 2.0, cx + w * res / 2.0, y_top)
        return OrthoPlan(tri=tri, tiles=tiles, focal=float(np.float32(dist / res)),
                         tile_w=tw, tile_h=th, width=w, height=h,
                         bounds=bounds, epsg=crs)

    def ortho_raster_census(
        self,
        plan: "OrthoPlan",
        config: typing.Optional[RasterConfig] = None,
    ) -> typing.List[int]:
        """Per-level maximum tile-list demand over the tiles of ``plan``
        (``bin_triangles`` census): caps at or above it drop nothing."""
        config = config or self.raster_config
        census = [
            bin_triangles(
                setup_triangles(transform_to_camera(plan.tri, w2c), plan.focal,
                                plan.tile_w, plan.tile_h, config.znear),
                config, plan.tile_h, plan.tile_w, return_census=True)
            for _, _, w2c in plan.tiles
        ]
        return torch.stack(census).amax(0).tolist()

    def view_raster_census(
        self,
        cameras: CameraSet,
        image_scale: float = 1.0,
        config: typing.Optional[RasterConfig] = None,
    ) -> typing.List[int]:
        """Per-level maximum tile-list demand over every view's pinhole
        render at ``image_scale`` (the planner's census, one fetch for all
        views): caps at or above it drop nothing."""
        config = _planner.census_config_of(config or self.raster_config)
        soa = self._tri_soa_device(cameras, config.bin_block)
        census = []
        for i in range(len(cameras)):
            batch = cameras.get_camera_batch([i], image_scale=image_scale,
                                             device=self.device)
            row = torch.as_tensor(_planner.pack_camera_batch(batch, np.ones(1))[0],
                                  device=self.device)
            census.append(_planner.census_view(soa, row, config, False,
                                               batch.image_height, batch.image_width))
        return torch.stack(census).amax(0).tolist()

    def ortho_pix2face(
        self,
        crs: typing.Optional[int] = None,
        resolution_m: float = 0.2,
        max_pixels: int = 8192,
        max_total_pixels: int = 2 ** 28,
        stats: typing.Optional[dict] = None,
    ):
        """Orthographic top-down pix2face over the mesh footprint.

        The building block for vector export and polygon labeling: an
        orthographic view is a pinhole camera at a great distance with a
        long focal length (see :meth:`ortho_plan`).  Footprints needing
        more than ``max_pixels`` per axis are rendered as a grid of tiles
        of one shape at the full resolution (the camera translates per
        tile; edge tiles crop the paste); only past ``max_total_pixels``
        is the resolution clamped, with a warning.  Tiles run on the
        mesh's device through the raster chain at the mesh's
        ``raster_config`` and are pasted into one host array.  Every
        tile's overflow is read once after the last: any dropped candidate
        raises, naming the tiles and the caps (:meth:`ortho_plan` and
        :meth:`ortho_raster_census` size caps that hold).  ``stats`` (a
        dict) receives ``raster_s`` and ``download_s``.

        Returns (pix2face (H, W) int32, bounds (x0, y0, x1, y1), epsg).
        """
        config = self.raster_config
        plan = self.ortho_plan(crs, resolution_m, max_pixels, max_total_pixels)
        p2f = np.full((plan.height, plan.width), -1, np.int32)
        overflows, raster_s, download_s = [], 0.0, 0.0
        for i0, j0, w2c in plan.tiles:
            t0 = time.perf_counter()
            tile, overflow = rasterize_triangles(
                transform_to_camera(plan.tri, w2c), plan.focal, plan.tile_w,
                plan.tile_h, config, return_overflow=True)
            overflows.append(overflow)
            if tile.device.type == "cuda":
                torch.cuda.synchronize(tile.device)
            t1 = time.perf_counter()
            h_eff = min(plan.tile_h, plan.height - i0)
            w_eff = min(plan.tile_w, plan.width - j0)
            p2f[i0:i0 + h_eff, j0:j0 + w_eff] = tile[:h_eff, :w_eff].cpu().numpy()
            raster_s += t1 - t0
            download_s += time.perf_counter() - t1
        dropped = torch.stack(overflows).cpu().tolist()
        over = [(plan.tiles[k][0], plan.tiles[k][1], int(n))
                for k, n in enumerate(dropped) if n]
        if over:
            raise RuntimeError(
                f"ortho_pix2face: raster capacity overflow in tiles (row, column, "
                f"dropped) {over} of {plan.tile_h}x{plan.tile_w} px at caps "
                f"{tuple(config.caps)}: the pix2face is incomplete. Give the mesh a "
                "raster_config with larger caps (ortho_raster_census sizes them)."
            )
        if stats is not None:
            stats.update(raster_s=raster_s, download_s=download_s,
                         tiles=len(plan.tiles))
        return p2f, plan.bounds, plan.epsg

    @staticmethod
    def _label_image(p2f: np.ndarray, face_values: np.ndarray) -> np.ndarray:
        """Per-pixel value of the face a pixel sees, NaN on background."""
        with np.errstate(invalid="ignore"):
            return np.where(p2f >= 0, face_values[np.clip(p2f, 0, None)], np.nan)

    def export_face_labels_vector(
        self,
        face_labels: typing.Optional[np.ndarray] = None,
        export_file: typing.Optional[PATH_TYPE] = None,
        label_names: typing.Optional[dict] = None,
        resolution_m: float = 0.2,
        mode: str = "exact",
        stats: typing.Optional[dict] = None,
    ) -> VectorData:
        """Per-face labels -> geospatial polygons (reference
        meshes.py:1284-1423), columns ``class_ID`` and ``names``, in the
        working UTM CRS when georeferenced.

        ``mode="exact"`` (default): class regions derived combinatorially
        from shared mesh edges
        (:func:`~geograypher_tpu_torch.utils.exact_geometry.class_region_polygons`),
        every output vertex an exact mesh vertex.  ``mode="raster"``: the
        faces rendered orthographically at ``resolution_m``
        (:meth:`ortho_pix2face`) and each class mask traced
        (``polygons_from_mask``), for meshes whose top-down projection
        overlaps itself.  ``stats`` (a dict) receives the raster mode's
        ``ortho_s``, ``contours_s`` and ``write_s``.
        """
        if face_labels is None:
            face_labels = self.get_texture(request_vertex_texture=False)
        face_labels = np.asarray(face_labels).reshape(-1)
        label_names = label_names or self.IDs_to_labels or {}
        geoms, names, ids = [], [], []
        t0 = time.perf_counter()
        if mode == "exact":
            from geograypher_tpu_torch.utils.exact_geometry import class_region_polygons

            crs = self.get_working_projected_CRS() if self.CRS is not None else None
            verts2d = self.get_vertices_in_CRS(crs)[:, :2]
            regions = class_region_polygons(verts2d, self.faces, face_labels)
            for c in sorted(regions):
                for poly in regions[c]:
                    geoms.append(poly)
                    ids.append(int(c))
                    names.append(label_names.get(int(c), int(c)))
        elif mode == "raster":
            p2f, bounds, crs = self.ortho_pix2face(resolution_m=resolution_m,
                                                   stats=stats)
            t1 = time.perf_counter()
            label_img = self._label_image(p2f, face_labels)
            for c in np.unique(label_img[np.isfinite(label_img)]).astype(int):
                for poly in polygons_from_mask(label_img == c, bounds):
                    geoms.append(poly)
                    ids.append(int(c))
                    names.append(label_names.get(int(c), int(c)))
            if stats is not None:
                stats.update(ortho_s=t1 - t0, contours_s=time.perf_counter() - t1)
        else:
            raise ValueError(f"unknown mode {mode!r}: 'exact' or 'raster'")
        out = VectorData(
            geoms,
            {"class_ID": ids, "names": [str(n) for n in names]},
            epsg=crs,
        )
        if export_file is not None:
            t2 = time.perf_counter()
            out.to_file(export_file)
            if stats is not None:
                stats["write_s"] = time.perf_counter() - t2
        return out

    def label_polygons(
        self,
        face_labels: np.ndarray,
        polygons: typing.Union[PATH_TYPE, VectorData],
        face_weighting: typing.Optional[np.ndarray] = None,
        sjoin_overlay: bool = True,  # accepted for API parity; unused
        return_class_labels: bool = True,
        unknown_class_label: str = "unknown",
        resolution_m: float = 0.2,
        mode: str = "raster",
        stats: typing.Optional[dict] = None,
    ) -> list:
        """Assign each polygon the area-weighted dominant face class
        (reference meshes.py:1117-1282).

        ``mode="raster"`` (default) rasterizes both layers onto a common
        ortho grid (:meth:`ortho_pix2face` and ``rasterize_polygons``);
        the joint (polygon, class) histogram, weighted by
        ``face_weighting``, gives the area weighting at ``resolution_m``.
        ``mode="exact"`` computes true triangle-polygon intersection
        areas by convex clipping (``utils/exact_geometry.py``).  Negative
        and NaN labels do not vote; a polygon with no vote gets
        ``unknown_class_label`` (NaN without class labels).  ``stats`` (a
        dict) receives the raster mode's ``ortho_s``, ``polygons_s`` and
        ``histogram_s``.
        """
        if not isinstance(polygons, VectorData):
            polygons = VectorData.read_file(polygons)
        face_labels = np.asarray(face_labels).reshape(-1)
        if mode == "exact":
            return self._label_polygons_exact(
                face_labels, polygons, face_weighting,
                return_class_labels, unknown_class_label,
            )
        t0 = time.perf_counter()
        p2f, bounds, crs = self.ortho_pix2face(resolution_m=resolution_m,
                                               stats=stats)
        t1 = time.perf_counter()
        if polygons.epsg is not None and crs is not None:
            polygons = polygons.to_crs(crs)
        poly_img = rasterize_polygons(
            list(polygons.geometries), list(range(len(polygons))), bounds, p2f.shape)
        t2 = time.perf_counter()
        label_img = self._label_image(p2f, face_labels)
        weight_img = None
        if face_weighting is not None:
            face_weighting = np.asarray(face_weighting).reshape(-1)
            weight_img = np.where(
                p2f >= 0, face_weighting[np.clip(p2f, 0, None)], 0.0)
        # negative labels (e.g. -1 unlabeled sentinel) are ignored, as in
        # the exact mode
        valid = (poly_img >= 0) & np.isfinite(label_img) & (label_img >= 0)
        n_classes = (
            int(np.nanmax(face_labels)) + 1
            if np.isfinite(face_labels).any() and np.nanmax(face_labels) >= 0
            else 1
        )
        flat_idx = (poly_img[valid].astype(np.int64) * n_classes
                    + label_img[valid].astype(np.int64))
        weights = weight_img[valid] if weight_img is not None else None
        hist = np.bincount(
            flat_idx, weights=weights, minlength=len(polygons) * n_classes
        ).reshape(len(polygons), n_classes)
        best = np.argmax(hist, axis=1).astype(float)
        best[hist.sum(axis=1) == 0] = np.nan
        if stats is not None:
            stats.update(ortho_s=t1 - t0, polygons_s=t2 - t1,
                         histogram_s=time.perf_counter() - t2)
        return self._named_labels(best, return_class_labels, unknown_class_label)

    def _named_labels(self, best, return_class_labels, unknown_class_label):
        if return_class_labels:
            ids_to_labels = self.IDs_to_labels or {}
            return [
                unknown_class_label if np.isnan(b) else ids_to_labels.get(int(b), int(b))
                for b in best
            ]
        return best.tolist()

    def _label_polygons_exact(
        self,
        face_labels: np.ndarray,
        polygons: VectorData,
        face_weighting: typing.Optional[np.ndarray],
        return_class_labels: bool,
        unknown_class_label: str,
    ) -> list:
        """Exact-area polygon labeling via convex clipping (see
        label_polygons mode="exact")."""
        from geograypher_tpu_torch.utils.exact_geometry import polygon_overlay_areas

        crs = self.get_working_projected_CRS() if self.CRS is not None else None
        if polygons.epsg is not None and crs is not None:
            polygons = polygons.to_crs(crs)
        verts2d = self.get_vertices_in_CRS(crs)[:, :2]
        tris = verts2d[self.faces]
        finite = np.isfinite(face_labels) & (face_labels >= 0)
        n_classes = int(face_labels[finite].max()) + 1 if finite.any() else 1
        weighting = (
            np.asarray(face_weighting).reshape(-1)
            if face_weighting is not None
            else np.ones(len(face_labels))
        )
        best = np.full(len(polygons), np.nan)
        for pi, poly in enumerate(polygons.geometries):
            areas = polygon_overlay_areas(tris, poly)
            sel = (areas > 0) & finite
            if not sel.any():
                continue
            hist = np.bincount(
                face_labels[sel].astype(np.int64),
                weights=areas[sel] * weighting[sel],
                minlength=n_classes,
            )
            if hist.sum() > 0:
                best[pi] = float(np.argmax(hist))
        return self._named_labels(best, return_class_labels, unknown_class_label)

    def export_covering_meshes(
        self,
        N: int,
        z_buffer: tuple = (0.0, 0.0),
        subsample: typing.Optional[int] = None,
        frame_transform: typing.Optional[np.ndarray] = None,
    ):
        """Ceiling/floor covering surfaces over the mesh footprint
        (reference meshes.py:2366-2447): an (N, N) grid of the per-cell
        max/min z, returned as (verts, faces) triangle meshes.

        ``frame_transform`` (local->ECEF 4x4) evaluates the covering in a
        camera set's local frame (the triangulation workflow's frame).

        Returns ((top_verts, top_faces), (bottom_verts, bottom_faces)).
        """
        if frame_transform is not None:
            points = self.get_verts_in_local_frame(frame_transform)
        else:
            points = self.verts
        if subsample is not None:
            points = points[::subsample]
        if len(points) == 0:
            empty = (np.zeros((0, 3)), np.zeros((0, 3), np.int32))
            return empty, empty
        x_min, y_min = points[:, 0].min(), points[:, 1].min()
        x_max, y_max = points[:, 0].max(), points[:, 1].max()
        cw = max((x_max - x_min) / (N - 1), 1e-9)
        ch = max((y_max - y_min) / (N - 1), 1e-9)
        ix = np.clip(np.round((points[:, 0] - x_min) / cw).astype(int), 0, N - 1)
        iy = np.clip(np.round((points[:, 1] - y_min) / ch).astype(int), 0, N - 1)
        cell = iy * N + ix
        z_hi = np.full(N * N, -np.inf)
        z_lo = np.full(N * N, np.inf)
        np.maximum.at(z_hi, cell, points[:, 2])
        np.minimum.at(z_lo, cell, points[:, 2])
        # empty cells take the global extremes (a conservative cover)
        z_hi[~np.isfinite(z_hi)] = points[:, 2].max()
        z_lo[~np.isfinite(z_lo)] = points[:, 2].min()
        z_hi = z_hi.reshape(N, N) + z_buffer[0]
        z_lo = z_lo.reshape(N, N) + z_buffer[1]

        xs = np.linspace(x_min, x_max, N)
        ys = np.linspace(y_min, y_max, N)
        xx, yy = np.meshgrid(xs, ys, indexing="xy")
        iy_g, ix_g = np.meshgrid(np.arange(N - 1), np.arange(N - 1), indexing="ij")
        v00 = (iy_g * N + ix_g).ravel()
        tri_a = np.stack([v00, v00 + 1, v00 + N + 1], axis=1)
        tri_b = np.stack([v00, v00 + N + 1, v00 + N], axis=1)
        faces = np.concatenate([tri_a, tri_b], axis=1).reshape(-1, 3).astype(np.int32)

        top = (np.stack([xx.ravel(), yy.ravel(), z_hi.ravel()], axis=1), faces)
        bottom = (np.stack([xx.ravel(), yy.ravel(), z_lo.ravel()], axis=1),
                  faces.copy())
        return top, bottom

    def export_html_viewer(
        self,
        path: PATH_TYPE,
        cameras: typing.Optional[CameraSet] = None,
        max_faces: int = 400_000,
        frustum_scale: typing.Optional[float] = None,
    ) -> None:
        """Write a self-contained interactive 3D viewer as one HTML file
        (``utils/html_viewer.py``): the mesh (decimated to about
        ``max_faces``) coloured by its texture, a multi-class texture by
        its argmax, in the cameras' local frame, with each camera's
        frustum.  The frustums take the cameras' float32 poses and focal
        lengths, as a camera batch holds them, on the host."""
        from geograypher_tpu_torch.utils.html_viewer import (
            export_html_viewer,
            frustum_lines,
        )

        mesh = self
        if self.n_faces > max_faces:
            mesh = self.downsample(max_faces / self.n_faces)
        verts = mesh.get_verts_in_local_frame(cameras)
        tex = mesh.get_texture(
            request_vertex_texture=False, try_verts_faces_conversion=True
        )
        face_values = None
        if tex is not None:
            tex = np.asarray(tex)
            face_values = (
                np.nanargmax(np.nan_to_num(tex), axis=1).astype(float)
                if tex.ndim == 2 and tex.shape[1] > 1
                else tex.reshape(-1)
            )
        frustums = None
        if cameras is not None and len(cameras):
            span = float(np.abs(verts - verts.mean(axis=0)).max()) or 1.0
            scale = frustum_scale or span * 0.08
            frustums = []
            for i in range(len(cameras)):
                sensor = cameras.sensors[cameras.sensor_IDs[i]]
                frustums.append(frustum_lines(
                    cameras.cam_to_world_transforms[i].astype(np.float32),
                    float(np.float32(sensor["f"])),
                    int(sensor["image_width"]),
                    int(sensor["image_height"]),
                    scale=scale,
                ))
        export_html_viewer(
            path, verts, mesh.faces, face_values=face_values,
            frustums=frustums, title=str(path),
        )

    def save_mesh(self, savepath: PATH_TYPE, write_texture: bool = True):
        """Write the geometry (and a vertex texture as colours) as PLY."""
        colors = None
        if write_texture and self.vertex_texture is not None:
            t = self.vertex_texture
            if t.shape[1] >= 3:
                colors = np.nan_to_num(t[:, :3])
            else:
                v = np.nan_to_num(t[:, 0])
                rng = v.max() - v.min() if v.size else 1.0
                g = (255 * (v - v.min()) / max(rng, 1e-9)).astype(np.uint8)
                colors = np.stack([g, g, g], axis=1)
        save_mesh(savepath, self.verts, self.faces, vert_colors=colors)
