"""Geospatial overlay helpers: the port's own copy of
``geograypher_tpu/utils/geospatial.py`` (counterpart of reference
utils/geospatial.py).

CRS plumbing lives in utils/crs.py; this module carries the overlay-style
operations: zonal statistics of rasters/vectors over polygons (replacing
rasterstats/gpd.overlay) and polygon de-overlapping.  All are raster-
assisted: layers are burned onto a shared grid and reduced with bincount,
giving the same area-weighted answers at controllable resolution.
"""

from __future__ import annotations

import logging
import typing

import numpy as np

from geograypher_tpu_torch.constants import PATH_TYPE
from geograypher_tpu_torch.utils import crs as crs_utils
from geograypher_tpu_torch.utils.vector import (
    Polygon,
    VectorData,
    polygons_from_mask,
    rasterize_polygons,
)

logger = logging.getLogger(__name__)

# Re-exports so ported call-sites find the reference's names here
ensure_projected_CRS = VectorData.ensure_projected
get_projected_CRS = crs_utils.utm_epsg_for


def get_overlap_raster(
    unlabeled_polygons: typing.Union[PATH_TYPE, VectorData],
    classified_raster: PATH_TYPE,
    num_classes: typing.Optional[int] = None,
    nodata: int = 255,
) -> typing.Tuple[np.ndarray, dict]:
    """Per-polygon class-pixel histograms from a classified raster
    (reference geospatial.py:150-219, rasterstats zonal_stats).

    Returns (counts (n_polygons, num_classes), ids_to_classes).
    """
    from geograypher_tpu_torch.utils.raster import read_geotiff

    if not isinstance(unlabeled_polygons, VectorData):
        unlabeled_polygons = VectorData.read_file(unlabeled_polygons)
    raster = read_geotiff(classified_raster)
    if unlabeled_polygons.epsg is not None and raster.epsg is not None:
        unlabeled_polygons = unlabeled_polygons.to_crs(raster.epsg)
    h, w = raster.data.shape[:2]
    poly_img = rasterize_polygons(
        unlabeled_polygons.geometries,
        list(range(len(unlabeled_polygons))),
        raster.bounds,
        (h, w),
    )
    data = raster.data if raster.data.ndim == 2 else raster.data[..., 0]
    data = data.astype(np.int64)
    # negative pixels (int16/int32 nodata like -9999) would index the
    # bincount negatively — class ids are non-negative by contract
    valid = (poly_img >= 0) & (data != nodata) & (data >= 0)
    if num_classes is None:
        num_classes = int(data[valid].max()) + 1 if valid.any() else 1
    valid &= data < num_classes
    flat = poly_img[valid].astype(np.int64) * num_classes + data[valid]
    counts = np.bincount(
        flat, minlength=len(unlabeled_polygons) * num_classes
    ).reshape(len(unlabeled_polygons), num_classes)
    return counts, {i: i for i in range(num_classes)}


def get_overlap_vector(
    unlabeled_polygons: typing.Union[PATH_TYPE, VectorData],
    classified_polygons: typing.Union[PATH_TYPE, VectorData],
    class_column: str,
    grid: int = 2048,
    mode: str = "raster",
) -> typing.Tuple[np.ndarray, list]:
    """Per-polygon area overlap with each class of a labeled polygon layer
    (reference geospatial.py:221-331, gpd overlay + groupby).

    ``mode="exact"`` computes true pairwise intersection areas by convex
    clipping (utils/exact_geometry) instead of the common-grid raster —
    the reference's GEOS-exact behavior.

    Returns (areas (n_polygons, n_classes) in CRS units^2, class_names).
    """
    if not isinstance(unlabeled_polygons, VectorData):
        unlabeled_polygons = VectorData.read_file(unlabeled_polygons)
    if not isinstance(classified_polygons, VectorData):
        classified_polygons = VectorData.read_file(classified_polygons)
    unlabeled_polygons = unlabeled_polygons.ensure_projected()
    if classified_polygons.epsg is not None:
        if unlabeled_polygons.epsg is None:
            raise ValueError(
                "unlabeled polygons carry no CRS but the classified layer "
                "does — load them with an explicit CRS (e.g. a .prj "
                "sidecar) so the layers can be aligned"
            )
        classified_polygons = classified_polygons.to_crs(unlabeled_polygons.epsg)

    col = classified_polygons.attributes[class_column]
    class_names = sorted({v for v in col if v is not None}, key=str)
    name_to_id = {c: i for i, c in enumerate(class_names)}

    if mode == "exact":
        from geograypher_tpu_torch.utils.exact_geometry import (
            polygon_intersection_area,
        )

        areas = np.zeros((len(unlabeled_polygons), len(class_names)))
        for pi, pg in enumerate(unlabeled_polygons.geometries):
            for cg, cname in zip(classified_polygons.geometries, col):
                ci = name_to_id.get(cname, -1)
                if ci < 0:
                    continue
                areas[pi, ci] += polygon_intersection_area(pg, cg)
        return areas, class_names

    b1 = unlabeled_polygons.total_bounds()
    b2 = classified_polygons.total_bounds()
    bounds = (
        min(b1[0], b2[0]), min(b1[1], b2[1]),
        max(b1[2], b2[2]), max(b1[3], b2[3]),
    )
    px_area = ((bounds[2] - bounds[0]) / grid) * ((bounds[3] - bounds[1]) / grid)
    poly_img = rasterize_polygons(
        unlabeled_polygons.geometries,
        list(range(len(unlabeled_polygons))),
        bounds,
        (grid, grid),
    )
    cls_img = rasterize_polygons(
        classified_polygons.geometries,
        [name_to_id.get(v, -1) for v in col],
        bounds,
        (grid, grid),
    )
    valid = (poly_img >= 0) & (cls_img >= 0)
    n = len(class_names)
    flat = poly_img[valid].astype(np.int64) * n + cls_img[valid]
    areas = (
        np.bincount(flat, minlength=len(unlabeled_polygons) * n)
        .reshape(len(unlabeled_polygons), n)
        .astype(float)
        * px_area
    )
    return areas, class_names


def ensure_non_overlapping_polygons(
    vector: VectorData, grid: int = 4096, method: str = "auto"
) -> VectorData:
    """Remove overlaps between polygons, smaller-area polygons keeping
    their territory (reference geospatial.py:74-110: area-sorted iterative
    difference).

    ``method="exact"`` uses the planar-arrangement boolean engine
    (:mod:`utils.boolean_ops`) — same answers GEOS would give, no raster
    quantization.  ``"raster"`` burns polygons in DESCENDING area order
    (smaller overwrite larger) onto a ``grid``-sized image and
    re-vectorizes.  ``"auto"`` (default) picks exact up to ~10^5 edges
    (grid-accelerated arrangement, :mod:`utils.boolean_ops`).  NOTE:
    ``non_overlapping_exact`` differences polygons ITERATIVELY, so its
    cost scales with overlap count, not just edges — the threshold here
    is per-layer edges like the union's.
    """
    polys = [g for g in vector.geometries]
    n_edges = sum(int(p.exterior.shape[0]) for p in polys) + sum(
        int(h.shape[0]) for p in polys for h in p.holes
    )
    if method == "exact" or (method == "auto" and n_edges <= 100_000):
        from geograypher_tpu_torch.utils.boolean_ops import non_overlapping_exact

        parts_per_row = non_overlapping_exact(polys)
        out_geoms = []
        dropped = total = 0.0
        for parts in parts_per_row:
            if not parts:
                out_geoms.append(Polygon(np.zeros((0, 2))))
                continue
            # single-geometry rows (no MultiPolygon type here): keep the
            # largest part; disconnected remainders are dropped and
            # reported (the reference keeps them as MultiPolygons)
            best = max(parts, key=lambda p: p.area)
            out_geoms.append(best)
            total += sum(p.area for p in parts)
            dropped += sum(p.area for p in parts) - best.area
        if total > 0 and dropped > 1e-9 * total:
            logger.warning(
                "ensure_non_overlapping_polygons dropped %.2f%% of polygon "
                "area as disconnected fragments (each row keeps only its "
                "largest de-overlapped part)",
                100.0 * dropped / total,
            )
        return VectorData(out_geoms, vector.attributes, vector.epsg)
    order = np.argsort([-p.area for p in polys])
    bounds = vector.total_bounds()
    pad = max(bounds[2] - bounds[0], bounds[3] - bounds[1]) * 0.01 + 1e-9
    bounds = (bounds[0] - pad, bounds[1] - pad, bounds[2] + pad, bounds[3] + pad)
    img = rasterize_polygons(
        [polys[i] for i in order], [int(i) for i in order], bounds, (grid, grid)
    )
    out_geoms: list = [None] * len(polys)
    dropped = 0.0
    total = 0.0
    for i in range(len(polys)):
        parts = polygons_from_mask(img == i, bounds)
        if not parts:
            out_geoms[i] = Polygon(np.zeros((0, 2)))
        else:
            # single-geometry rows (no MultiPolygon type here): keep the
            # largest fragment; disconnected remainders are dropped and
            # reported (the reference keeps them as MultiPolygons)
            best = max(parts, key=lambda p: p.area)
            out_geoms[i] = best
            total += sum(p.area for p in parts)
            dropped += sum(p.area for p in parts) - best.area
    if total > 0 and dropped > 1e-6 * total:
        logger.warning(
            "ensure_non_overlapping_polygons dropped %.2f%% of polygon "
            "area as disconnected fragments (each row keeps only its "
            "largest de-overlapped part)",
            100.0 * dropped / total,
        )
    return VectorData(out_geoms, vector.attributes, vector.epsg)
