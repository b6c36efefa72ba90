"""Spatially chunked processing for survey-scale meshes, in PyTorch.

Port of ``geograypher_tpu/meshes/chunked.py``: cluster the camera
locations with KMeans (:mod:`geograypher_tpu_torch.utils.kmeans`, seeded),
cut a buffered sub-mesh around each cluster (keeping its faces' ids in the
full mesh), process each chunk, and add the results back into full-mesh
arrays by those ids.

Views dealt over devices (``parallel/sharding.py``,
``parallel/pipeline.py``) keep the mesh whole; chunking is for a mesh
that outgrows one device, and its camera cluster -> sub-mesh cut is what a
face-sharded variant would use.  A chunk's buffered box is cut exactly
(``TexturedMesh.select_mesh_ROI`` with no buffer of its own), as in the
JAX package.
"""

from __future__ import annotations

import logging
import typing

import numpy as np

from geograypher_tpu_torch.cameras.core import CameraSet
from geograypher_tpu_torch.constants import CHUNKED_MESH_BUFFER_DIST_METERS
from geograypher_tpu_torch.meshes.mesh import TexturedMesh
from geograypher_tpu_torch.utils import crs as crs_utils
from geograypher_tpu_torch.utils.kmeans import kmeans
from geograypher_tpu_torch.utils.vector import Polygon, VectorData

logger = logging.getLogger(__name__)


def _camera_utm_coords(cameras: CameraSet):
    """((N, 2) planar camera coords, epsg-or-None): projected UTM when
    georeferenced, else the local frame -- the one projection rule of
    clustering and chunk footprints."""
    lon_lats = cameras.get_lon_lat_coords()
    if lon_lats and lon_lats[0] is not None:
        lla = np.array([[ll[1], ll[0], 0.0] for ll in lon_lats])
        utm = crs_utils.utm_epsg_for(lla[0, 0], lla[0, 1])
        return crs_utils.transform_points(lla, 4326, utm)[:, :2], utm
    return cameras.get_camera_locations()[:, :2], None


def _cluster(points: np.ndarray, n_clusters: int, seed: int) -> list:
    """Seeded KMeans of (N, 2) points -> per-cluster index arrays."""
    n_clusters = min(n_clusters, len(points))
    labels, _ = kmeans(points, n_clusters, n_init=10, seed=seed)
    return [np.where(labels == k)[0] for k in range(n_clusters)]


def cluster_cameras(
    cameras: CameraSet, n_clusters: int, seed: int = 0
) -> typing.List[np.ndarray]:
    """KMeans over camera locations -> per-cluster camera index arrays.
    Uses projected (UTM) coords when georeferenced, else local coords."""
    pts, _epsg = _camera_utm_coords(cameras)
    return _cluster(pts, n_clusters, seed)


def mesh_chunk_for_cameras(
    mesh: TexturedMesh,
    cameras: CameraSet,
    camera_indices: np.ndarray,
    buffer_meters: float = CHUNKED_MESH_BUFFER_DIST_METERS,
):
    """The sub-mesh inside the cameras' bounding box grown by
    ``buffer_meters``, and the ids of its faces in ``mesh``."""
    all_pts, epsg = _camera_utm_coords(cameras)
    pts = all_pts[np.asarray(camera_indices)]
    x0, y0 = pts.min(axis=0) - buffer_meters
    x1, y1 = pts.max(axis=0) + buffer_meters
    hull = Polygon(np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]]))
    sub, face_mask = mesh.select_mesh_ROI(
        VectorData([hull], epsg=epsg), inplace=False
    )
    return sub, np.where(face_mask)[0]


def aggregate_images_chunked(
    mesh: TexturedMesh,
    cameras: CameraSet,
    n_clusters: int = 8,
    buffer_meters: float = CHUNKED_MESH_BUFFER_DIST_METERS,
    aggregate_img_scale: float = 1.0,
    **kwargs,
):
    """``aggregate_projected_images`` one camera cluster at a time on its
    buffered sub-mesh, each chunk's summed projections and view counts
    added back by face id.  ``kwargs`` go to
    ``aggregate_projected_images``.  Returns ``(average (F, C) with NaN on
    unseen faces, {"projection_counts", "summed_projections"})``."""
    clusters = cluster_cameras(cameras, n_clusters)
    n_faces = mesh.n_faces
    total_sum = None
    total_count = np.zeros(n_faces)
    for k, cam_idx in enumerate(clusters):
        if len(cam_idx) == 0:
            continue
        sub_mesh, face_ids = mesh_chunk_for_cameras(
            mesh, cameras, cam_idx, buffer_meters
        )
        if sub_mesh.n_faces == 0:
            continue
        sub_cams = cameras.get_subset_cameras(cam_idx)
        logger.info(
            "chunk %d: %d cameras, %d faces", k, len(cam_idx), sub_mesh.n_faces
        )
        _, info = sub_mesh.aggregate_projected_images(
            sub_cams, aggregate_img_scale=aggregate_img_scale, **kwargs
        )
        sums = info["summed_projections"]
        if total_sum is None:
            total_sum = np.zeros((n_faces, sums.shape[1]))
        # face ids are unique within a chunk: plain indexed adds
        total_sum[face_ids] += np.nan_to_num(sums)
        total_count[face_ids] += info["projection_counts"]
    if total_sum is None:
        raise ValueError("No chunks produced data")
    with np.errstate(invalid="ignore", divide="ignore"):
        avg = total_sum / total_count[:, None]
    avg[total_count == 0] = np.nan
    return avg, {
        "projection_counts": total_count,
        "summed_projections": total_sum,
    }


def render_flat_chunked(
    mesh: TexturedMesh,
    cameras: CameraSet,
    n_cameras_per_chunk: int = 100,
    buffer_meters: float = CHUNKED_MESH_BUFFER_DIST_METERS,
    **render_kwargs,
):
    """Generator of ``(render, camera)`` for every camera, cluster by
    cluster, each rendered from its cluster's buffered sub-mesh
    (``render_kwargs`` go to ``render_flat``)."""
    n_clusters = max(len(cameras) // max(n_cameras_per_chunk, 1), 1)
    clusters = cluster_cameras(cameras, n_clusters)
    for cam_idx in clusters:
        if len(cam_idx) == 0:
            continue
        sub_mesh, _ = mesh_chunk_for_cameras(
            mesh, cameras, cam_idx, buffer_meters
        )
        sub_mesh.IDs_to_labels = mesh.IDs_to_labels
        sub_cams = cameras.get_subset_cameras(cam_idx)
        yield from sub_mesh.render_flat(
            sub_cams, return_camera=True, **render_kwargs
        )


def label_polygons_chunked(
    mesh: TexturedMesh,
    face_labels: np.ndarray,
    polygons: VectorData,
    polygons_per_cluster: int = 1000,
    **kwargs,
):
    """Polygon labelling one spatial cluster of polygons (KMeans of their
    centroids) at a time against the mesh (``TexturedMesh.label_polygons``
    with ``kwargs``); the labels in the polygons' order."""
    n = len(polygons)
    n_clusters = max(n // polygons_per_cluster, 1)
    cents = np.array([g.centroid for g in polygons.geometries])
    out: list = [None] * n
    for idx in _cluster(cents, n_clusters, seed=0):
        sub_polys = VectorData(
            [polygons.geometries[i] for i in idx],
            {key: [v[i] for i in idx] for key, v in polygons.attributes.items()},
            epsg=polygons.epsg,
        )
        labels = mesh.label_polygons(face_labels, sub_polys, **kwargs)
        for i, lab in zip(idx, labels):
            out[i] = lab
    return out


def aggregate_class_images_chunked_distributed(
    mesh: TexturedMesh,
    cameras: CameraSet,
    n_classes: int,
    n_clusters: int = 4,
    buffer_meters: float = CHUNKED_MESH_BUFFER_DIST_METERS,
    class_image_provider: typing.Optional[
        typing.Callable[[int], np.ndarray]
    ] = None,
    **pipeline_kwargs,
):
    """Each camera cluster's buffered sub-mesh through the survey pipeline
    (``parallel.pipeline.aggregate_class_images_distributed``: views dealt
    over the devices, loading and uploads overlapped with the kernels),
    the per-chunk results added back by face id.  Returns
    ``(fraction_sums (F, C), view_counts (F,))`` as the unchunked
    pipeline does."""
    from geograypher_tpu_torch.parallel.pipeline import (
        aggregate_class_images_distributed,
    )

    clusters = cluster_cameras(cameras, n_clusters)
    total_fracs = np.zeros((mesh.n_faces, n_classes))
    total_views = np.zeros(mesh.n_faces)
    produced = False
    for k, cam_idx in enumerate(clusters):
        if len(cam_idx) == 0:
            continue
        sub_mesh, face_ids = mesh_chunk_for_cameras(
            mesh, cameras, cam_idx, buffer_meters
        )
        if sub_mesh.n_faces == 0:
            continue
        sub_cams = cameras.get_subset_cameras(cam_idx)
        logger.info(
            "distributed chunk %d: %d cameras, %d faces",
            k, len(cam_idx), sub_mesh.n_faces,
        )
        provider = None
        if class_image_provider is not None:
            # the subset's view index back to the survey's
            def provider(j, _idx=np.asarray(cam_idx)):
                return class_image_provider(int(_idx[j]))

        fracs, views = aggregate_class_images_distributed(
            sub_mesh, sub_cams, n_classes,
            class_image_provider=provider, **pipeline_kwargs,
        )
        total_fracs[face_ids] += np.nan_to_num(fracs)
        total_views[face_ids] += views
        produced = True
    if not produced:
        raise ValueError("No chunks produced data")
    return total_fracs, total_views
