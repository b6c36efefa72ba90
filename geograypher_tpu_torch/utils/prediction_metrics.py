"""Evaluation metrics for geospatial predictions: the port's counterpart of
``geograypher_tpu/utils/prediction_metrics.py``.

Confusion matrices between predicted and ground-truth maps (raster or
vector), accuracy, and class-averaged precision and recall.
Vector-vector comparison burns both layers onto a common grid
(``mode="raster"``) or intersects the polygons exactly (``mode="exact"``,
``utils/exact_geometry.py``).  Raster-raster comparison samples the finer
raster at the coarser one's pixel centres on the host, then looks every
pixel's value up in the class list and counts the (true, predicted) pairs
with one ``bincount`` on ``device``, where the JAX package makes two
``np.vectorize`` calls of a dict lookup (10^8 Python calls at 10,000^2).
The plots import matplotlib when called and run on the host.
"""

from __future__ import annotations

import typing
from pathlib import Path

import numpy as np
import torch

from geograypher_tpu_torch.constants import PATH_TYPE
from geograypher_tpu_torch.utils.device import resolve_device


def check_if_raster(filename: PATH_TYPE) -> bool:
    """Classify a geodata file as raster or vector (reference :27-35)."""
    suffix = Path(filename).suffix.lower()
    if suffix in (".tif", ".tiff"):
        return True
    if suffix in (".geojson", ".json", ".gpkg", ".shp"):
        return False
    raise ValueError(f"Unknown geodata extension {suffix}")


def cf_from_vector_vector(
    predicted,
    true,
    column_name: str,
    class_names: typing.Optional[list] = None,
    grid: int = 2048,
    include_unlabeled: bool = True,
    mode: str = "raster",
):
    """Confusion matrix weighted by intersection area between two polygon
    layers (reference :95-145).

    ``mode="raster"`` (default) burns both layers onto a common grid;
    ``mode="exact"`` computes true pairwise polygon intersection areas
    by convex clipping (``utils/exact_geometry.py``), with no grid
    quantization.

    Returns (cf (C[+1], C[+1]) areas, class_names).  The trailing
    row/column is the unlabeled class when requested.
    """
    from geograypher_tpu_torch.utils.vector import VectorData, rasterize_polygons

    if not isinstance(predicted, VectorData):
        predicted = VectorData.read_file(predicted)
    if not isinstance(true, VectorData):
        true = VectorData.read_file(true)
    if predicted.epsg is not None:
        predicted = predicted.ensure_projected()
        if true.epsg is not None:
            true = true.to_crs(predicted.epsg)

    if class_names is None:
        vals = set(predicted.attributes.get(column_name, [])) | set(
            true.attributes.get(column_name, [])
        )
        class_names = sorted({v for v in vals if v is not None}, key=str)
    name_to_id = {c: i for i, c in enumerate(class_names)}
    n = len(class_names)

    if mode == "exact":
        from geograypher_tpu_torch.utils.exact_geometry import (
            ear_clip,
            polygon_intersection_area,
        )

        size = n + 1 if include_unlabeled else n
        cf = np.zeros((size, size))

        def ids_areas(vd):
            ids = [
                name_to_id.get(v, n)
                for v in vd.attributes.get(column_name, [None] * len(vd))
            ]
            return ids, [g.area for g in vd.geometries]

        t_ids, t_areas = ids_areas(true)
        p_ids, p_areas = ids_areas(predicted)
        p_overlap = np.zeros(len(predicted))
        for ti, tg in enumerate(true.geometries):
            t_cov = 0.0
            # hoist the O(K^2) triangulation of tg out of the P-loop
            tg_tris = ear_clip(tg.exterior)
            tg_hole_tris = [ear_clip(h) for h in tg.holes]
            for pi, pg in enumerate(predicted.geometries):
                inter = polygon_intersection_area(
                    tg, pg, a_tris=tg_tris, a_hole_tris=tg_hole_tris
                )
                if inter <= 0:
                    continue
                t_cov += inter
                p_overlap[pi] += inter
                if t_ids[ti] < size and p_ids[pi] < size:
                    cf[t_ids[ti], p_ids[pi]] += inter
            if include_unlabeled and t_ids[ti] < size:
                # parts of the true polygon no prediction covers
                cf[t_ids[ti], n] += max(t_areas[ti] - t_cov, 0.0)
        if include_unlabeled:
            for pi in range(len(predicted)):
                if p_ids[pi] < size:
                    cf[n, p_ids[pi]] += max(
                        p_areas[pi] - p_overlap[pi], 0.0
                    )
        return cf, class_names

    bounds = true.total_bounds()
    px0, py0, px1, py1 = predicted.total_bounds()
    bounds = (
        min(bounds[0], px0), min(bounds[1], py0),
        max(bounds[2], px1), max(bounds[3], py1),
    )
    area_per_px = ((bounds[2] - bounds[0]) / grid) * ((bounds[3] - bounds[1]) / grid)

    def burn(vd):
        vals = [
            name_to_id.get(v, n)
            for v in vd.attributes.get(column_name, [None] * len(vd))
        ]
        return rasterize_polygons(
            vd.geometries, vals, bounds, (grid, grid), background=n
        )

    pred_img = burn(predicted)
    true_img = burn(true)
    size = n + 1 if include_unlabeled else n
    mask = np.ones_like(pred_img, bool)
    if not include_unlabeled:
        mask = (pred_img < n) & (true_img < n)
    flat = true_img[mask] * size + pred_img[mask]
    cf = np.bincount(flat, minlength=size * size).reshape(size, size).astype(float)
    cf *= area_per_px
    return cf, class_names


def _class_ids(values: torch.Tensor, keys: torch.Tensor, ids: torch.Tensor,
               n: int) -> torch.Tensor:
    """Each value's class id: ``ids[k]`` where ``values == keys[k]``
    (``keys`` sorted), ``n`` where no key matches."""
    if keys.numel() == 0:
        return torch.full_like(values, n)
    pos = torch.searchsorted(keys, values).clamp(max=keys.numel() - 1)
    return torch.where(keys[pos] == values, ids[pos], n)


def _fine_values(coarse, fine) -> np.ndarray:
    """The finer raster's first band at the coarser raster's pixel
    centres (nearest), NaN (nodata, outside) as -1, as ints: what the
    JAX package computes with ``fine.sample``.  For two north-up rasters a
    column's source column and a row's source row are each computed once
    (the same float64 arithmetic as ``Raster.sample``), and the samples
    are one gather."""
    h, w = coarse.data.shape[:2]
    fdata = fine.data if fine.data.ndim == 2 else fine.data[..., 0]
    if coarse.transform[1] == coarse.transform[3] == 0 and (
            fine.transform[1] == fine.transform[3] == 0):
        xs, _ = coarse.pixel_to_world(np.arange(w) + 0.5, np.zeros(w))
        _, ys = coarse.pixel_to_world(np.zeros(h), np.arange(h) + 0.5)
        col, _ = fine.world_to_pixel(xs, np.zeros(w))
        _, row = fine.world_to_pixel(np.zeros(h), ys)
        fh, fw = fdata.shape
        ci, ri = np.floor(col).astype(int), np.floor(row).astype(int)
        ok_c, ok_r = (ci >= 0) & (ci < fw), (ri >= 0) & (ri < fh)
        fv = fdata[np.clip(ri, 0, fh - 1)[:, None], np.clip(ci, 0, fw - 1)[None, :]]
        fv = fv.astype(np.float64)
        if fine.nodata is not None:
            fv[fv == fine.nodata] = np.nan
        fv[~(ok_r[:, None] & ok_c[None, :])] = np.nan
    else:
        cc, rr = np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5)
        xs, ys = coarse.pixel_to_world(cc.ravel(), rr.ravel())
        fv = fine.sample(xs, ys, method="nearest").reshape(
            (h, w) + fine.data.shape[2:])
        if fv.ndim == 3:
            fv = fv[..., 0]
    return np.where(np.isnan(fv), -1, fv).astype(int)


def compute_confusion_matrix_from_geospatial(
    prediction_file: PATH_TYPE,
    groundtruth_file: PATH_TYPE,
    column_name: str,
    class_names: typing.Optional[list] = None,
    grid: int = 2048,
    device="cuda",
):
    """Dispatch raster/vector comparison (reference :147-230).  Raster
    inputs are compared pixelwise at the coarser raster's pixel centres;
    the class lookup and the pair counts run on ``device`` (the card by
    default; raises without one).  The class list, when not given, holds
    every value either raster has, -1 (a fine pixel that is nodata or
    outside) and the nodata value included, as the JAX package's does."""
    pred_is_raster = check_if_raster(prediction_file)
    true_is_raster = check_if_raster(groundtruth_file)
    if not pred_is_raster and not true_is_raster:
        return cf_from_vector_vector(
            prediction_file, groundtruth_file, column_name,
            class_names=class_names, grid=grid,
        )
    if pred_is_raster and true_is_raster:
        from geograypher_tpu_torch.utils.raster import read_geotiff

        device = resolve_device(device, "compute_confusion_matrix_from_geospatial")
        pred = read_geotiff(prediction_file)
        true = read_geotiff(groundtruth_file)

        def px_area(r):
            return abs(r.transform[0] * r.transform[4]) or 1.0

        coarse, fine = (
            (true, pred) if px_area(true) >= px_area(pred) else (pred, true)
        )
        if (
            fine.epsg is not None
            and coarse.epsg is not None
            and fine.epsg != coarse.epsg
        ):
            fine = fine.reprojected(coarse.epsg)
        fine_vals = torch.as_tensor(_fine_values(coarse, fine), device=device)
        coarse_data = coarse.data if coarse.data.ndim == 2 else coarse.data[..., 0]
        coarse_vals = torch.as_tensor(np.asarray(coarse_data).astype(int), device=device)
        t, p = (coarse_vals, fine_vals) if coarse is true else (fine_vals, coarse_vals)
        if class_names is None:
            values = torch.unique(torch.cat([torch.unique(p), torch.unique(t)]))
            class_names = [np.int64(v) for v in values.cpu().numpy()]
        n = len(class_names)
        # the JAX package's dict: the last index of a repeated name; a
        # name that is not a number matches no pixel
        lut = {c: i for i, c in enumerate(class_names)}
        numeric = [(float(c), i) for c, i in lut.items()
                   if isinstance(c, (int, float, np.number))]
        numeric.sort()
        keys = torch.tensor([k for k, _ in numeric], dtype=torch.float64, device=device)
        ids = torch.tensor([i for _, i in numeric], dtype=torch.int64, device=device)
        pi = _class_ids(p.to(torch.float64), keys, ids, n)
        ti = _class_ids(t.to(torch.float64), keys, ids, n)
        ok = (pi < n) & (ti < n)
        cf = torch.bincount(ti[ok] * n + pi[ok], minlength=n * n)
        return cf.reshape(n, n).cpu().numpy().astype(float), class_names
    raise NotImplementedError("Mixed raster/vector comparison")


def _pyplot(what: str):
    """matplotlib's pyplot on its headless backend, or an ImportError
    naming matplotlib (the plots run on the host)."""
    try:
        import matplotlib
    except ImportError as err:
        raise ImportError(f"{what} plots with matplotlib, which is not "
                          "installed here") from err
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_geodata(
    filename: PATH_TYPE,
    ax=None,
    raster_downsample_factor: int = 8,
    class_column: typing.Optional[str] = None,
    ignore_class: int = 255,
    vis: bool = False,
):
    """Quick-look plot of a raster or vector geofile
    (reference prediction_metrics.py:37-93), headless matplotlib."""
    plt = _pyplot("plot_geodata")
    if ax is None:
        _, ax = plt.subplots()
    if check_if_raster(filename):
        from geograypher_tpu_torch.utils.raster import read_geotiff

        raster = read_geotiff(filename).downsampled(raster_downsample_factor)
        data = raster.data.astype(float)
        if data.ndim == 2:
            data[data == ignore_class] = np.nan
        x0, y0, x1, y1 = raster.bounds
        ax.imshow(data, extent=(x0, x1, y0, y1))
    else:
        from geograypher_tpu_torch.utils.vector import VectorData, rasterize_polygons

        vd = VectorData.read_file(filename)
        col = vd.attributes.get(class_column) if class_column else None
        if col is not None:
            classes = sorted({v for v in col if v is not None}, key=str)
            vals = [classes.index(v) if v in classes else -1 for v in col]
        else:
            vals = list(range(len(vd)))
        bounds = vd.total_bounds()
        img = rasterize_polygons(vd.geometries, vals, bounds, (512, 512))
        ax.imshow(
            np.where(img >= 0, img, np.nan),
            extent=(bounds[0], bounds[2], bounds[1], bounds[3]),
        )
    return ax


def compute_and_show_cf(
    pred_labels: np.ndarray,
    gt_labels: np.ndarray,
    labels: typing.Optional[list] = None,
    use_labels_from: str = "both",
    vis: bool = False,
    savefile: typing.Optional[PATH_TYPE] = None,
):
    """Confusion matrix from per-sample label lists + optional plot
    (reference prediction_metrics.py:232-291).

    Returns (cf, labels, accuracy)."""
    pred_labels = np.asarray(pred_labels)
    gt_labels = np.asarray(gt_labels)
    if labels is None:
        if use_labels_from == "pred":
            labels = sorted(set(pred_labels.tolist()), key=str)
        elif use_labels_from == "gt":
            labels = sorted(set(gt_labels.tolist()), key=str)
        else:
            labels = sorted(
                set(pred_labels.tolist()) | set(gt_labels.tolist()), key=str
            )
    lut = {l: i for i, l in enumerate(labels)}
    n = len(labels)
    cf = np.zeros((n, n), dtype=np.int64)
    for g, p in zip(gt_labels, pred_labels):
        if g in lut and p in lut:
            cf[lut[g], lut[p]] += 1
    accuracy = np.trace(cf) / max(cf.sum(), 1)
    if vis or savefile is not None:
        plt = _pyplot("compute_and_show_cf")
        fig, ax = plt.subplots()
        im = ax.imshow(cf)
        ax.set_xticks(range(n), [str(l) for l in labels], rotation=45)
        ax.set_yticks(range(n), [str(l) for l in labels])
        ax.set_xlabel("predicted")
        ax.set_ylabel("true")
        fig.colorbar(im)
        if savefile is not None:
            fig.savefig(savefile, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return cf, labels, float(accuracy)


def compute_comprehensive_metrics(cf: np.ndarray) -> dict:
    """Accuracy + class-averaged precision/recall from a confusion matrix
    (true on rows, predicted on columns; reference :293-335)."""
    cf = np.asarray(cf, dtype=float)
    total = cf.sum()
    accuracy = np.trace(cf) / total if total else np.nan
    with np.errstate(invalid="ignore", divide="ignore"):
        recall = np.diag(cf) / cf.sum(axis=1)
        precision = np.diag(cf) / cf.sum(axis=0)
    return {
        "accuracy": float(accuracy),
        "per_class_recall": recall,
        "per_class_precision": precision,
        "class_averaged_recall": float(np.nanmean(recall)),
        "class_averaged_precision": float(np.nanmean(precision)),
    }
