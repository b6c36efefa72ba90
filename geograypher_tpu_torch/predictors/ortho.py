"""Orthomosaic chip/assemble pipeline (non-multiview baseline).

Port of ``geograypher_tpu/predictors/ortho.py`` (the reference's
predictors/ortho_segmentor.py): slice a large orthomosaic into
overlapping chips with rasterized vector labels (``write_chips``,
reference :96-270), then assemble per-chip predictions into one class
raster with ramped edge down-weighting (``assemble_tiled_predictions``,
reference :273-431).  Windows are encoded in chip filenames exactly as
there (:32-38), so chips and predictions pair up by name.

Chips are written by the port's PNG codec in the channel order of the
JAX package's ``cv2.imwrite`` (a 3-channel chip is stored as BGR), so a
chip file holds the same pixels as the JAX package's.  The assembly keeps
its (H, W, C) counts on the card: each chip's pixels gather their count at
their predicted class, add the chip's ramped weight with saturation and
scatter it back (a pixel names one class, so a chip writes each count at
most once, and a saturating sum of nonnegative terms is the same in any
order); the argmax, the nodata fill and the counts' sum run there too.
:func:`assemble_tiled_predictions_plain` is the JAX package's numpy loop,
kept as the plain version.
"""

from __future__ import annotations

import time
import typing
from pathlib import Path

import numpy as np
import torch

from geograypher_tpu_torch.constants import PATH_TYPE
from geograypher_tpu_torch.utils.device import PinnedUpload, resolve_device
from geograypher_tpu_torch.utils.files import ensure_folder
from geograypher_tpu_torch.utils.io import read_image_or_numpy, write_image
from geograypher_tpu_torch.utils.numeric import create_ramped_weighting
from geograypher_tpu_torch.utils.raster import (
    Raster,
    read_geotiff,
    read_geotiff_grid,
    write_geotiff,
)

# count dtypes -> the torch dtype that holds them on the device (the
# unsigned types torch computes little with go one signed size up)
_DEVICE_COUNT_DTYPES = {
    np.dtype(np.uint8): torch.uint8, np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16, np.dtype(np.uint16): torch.int32,
    np.dtype(np.int32): torch.int32, np.dtype(np.uint32): torch.int64,
    np.dtype(np.int64): torch.int64,
}


def get_str_from_window(window: dict, suffix: str) -> str:
    """'<row>:<col>:<height>:<width><suffix>' filename encoding
    (reference ortho_segmentor.py:32-38)."""
    return (
        f"{window['row']}:{window['col']}:{window['height']}:{window['width']}"
        + suffix
    )


def parse_windows_from_files(
    files: typing.Sequence[Path],
) -> typing.List[dict]:
    """Recover window dicts from chip filenames (reference :40-81)."""
    windows = []
    for f in files:
        row, col, height, width = (int(x) for x in Path(f).stem.split(":"))
        windows.append(
            {"row": row, "col": col, "height": height, "width": width}
        )
    return windows


def create_windows(
    data_shape: typing.Tuple[int, int], chip_size: int, chip_stride: int
):
    """Sliding windows covering an (H, W) raster (reference :24-30)."""
    h, w = data_shape[:2]
    for row in range(0, h, chip_stride):
        for col in range(0, w, chip_stride):
            yield {
                "row": row,
                "col": col,
                "height": min(chip_size, h - row),
                "width": min(chip_size, w - col),
            }


def write_chips(
    raster_file: PATH_TYPE,
    output_folder: PATH_TYPE,
    chip_size: int,
    chip_stride: int,
    label_vector_file: typing.Optional[PATH_TYPE] = None,
    label_column: typing.Optional[str] = None,
    label_remap: typing.Optional[dict] = None,
    write_empty_tile_if_no_labels: bool = True,
    output_suffix: str = ".png",
    background_ind: int = 255,
    skip_all_nodata_tiles: bool = True,
) -> typing.Optional[dict]:
    """Chip an orthomosaic (+ optional rasterized vector labels) to disk
    (reference ortho_segmentor.py:96-270).

    Returns the label->index mapping when labels are written.
    """
    raster = read_geotiff(raster_file)
    data = raster.data
    imgs_folder = ensure_folder(Path(output_folder, "imgs"))

    label_img = None
    label_to_index = None
    if label_vector_file is not None:
        from geograypher_tpu_torch.utils.vector import (
            VectorData,
            rasterize_polygons,
        )

        vd = VectorData.read_file(label_vector_file)
        if vd.epsg is not None and raster.epsg is not None:
            vd = vd.to_crs(raster.epsg)
        if label_column is not None and label_column in vd.attributes:
            col = vd.attributes[label_column]
            if label_remap is not None:
                values = [label_remap.get(v, background_ind) for v in col]
                label_to_index = dict(label_remap)
            else:
                classes = sorted({v for v in col if v is not None}, key=str)
                label_to_index = {c: i for i, c in enumerate(classes)}
                values = [label_to_index.get(v, background_ind) for v in col]
        else:
            values = list(range(len(vd)))
            label_to_index = {i: i for i in values}
        h, w = data.shape[:2]
        label_img = rasterize_polygons(
            [g for g in vd.geometries],
            values,
            raster.bounds,
            (h, w),
            background=background_ind,
        )
        anns_folder = ensure_folder(Path(output_folder, "anns"))

    for window in create_windows(data.shape, chip_size, chip_stride):
        r, c = window["row"], window["col"]
        hh, ww = window["height"], window["width"]
        chip = data[r : r + hh, c : c + ww]
        if skip_all_nodata_tiles and chip.ndim == 3 and chip.shape[-1] == 4:
            if (chip[..., 3] == 0).all():
                continue
        name = get_str_from_window(window, output_suffix)
        # cv2.imwrite's channel order: a 3-channel array is stored as BGR
        img_out = chip[..., 2::-1] if chip.ndim == 3 and chip.shape[-1] >= 3 else chip
        label_chip = None
        if label_img is not None:
            label_chip = label_img[r : r + hh, c : c + ww]
            if (
                not write_empty_tile_if_no_labels
                and (label_chip == background_ind).all()
            ):
                # skip BEFORE writing the image chip: imgs/ and anns/
                # pair up by name (reference ortho_segmentor.py:228-231)
                continue
        write_image(imgs_folder / name, np.ascontiguousarray(img_out))
        if label_chip is not None:
            write_image(anns_folder / name, label_chip.astype(np.uint8))
    return label_to_index


def _read_prediction(f: PATH_TYPE, window: dict) -> np.ndarray:
    """A chip's (height, width) prediction, checked against its window."""
    pred = read_image_or_numpy(f)
    if pred.ndim == 3:
        pred = pred[..., 0]
    hh, ww = window["height"], window["width"]
    if pred.shape[:2] != (hh, ww):
        raise ValueError(
            f"prediction {f} shape {pred.shape[:2]} does not match "
            f"its filename-encoded window ({hh}, {ww}) — chips from "
            "write_chips are already edge-clipped; un-pad model "
            "outputs before assembly"
        )
    return pred


def _out_of_range(what: str, num_classes: int, nodataval: int) -> ValueError:
    return ValueError(
        f"{what} holds a value outside classes 0..{num_classes - 1} that is "
        f"not the nodata value {nodataval}")


def _write_outputs(raster_file, classes, counts_sum, class_savefile,
                   counts_savefile, nodataval):
    _, transform, epsg = read_geotiff_grid(raster_file)
    write_geotiff(class_savefile, Raster(data=classes, transform=transform,
                                         epsg=epsg, nodata=nodataval))
    if counts_savefile is not None:
        write_geotiff(counts_savefile, Raster(data=counts_sum, transform=transform,
                                              epsg=epsg))


def assemble_tiled_predictions(
    raster_file: PATH_TYPE,
    pred_files: typing.Sequence[PATH_TYPE],
    num_classes: int,
    class_savefile: PATH_TYPE,
    counts_savefile: typing.Optional[PATH_TYPE] = None,
    downweight_edge_frac: float = 0.25,
    nodataval: int = 255,
    count_dtype=np.uint8,
    max_overlapping_tiles: int = 4,
    device="cuda",
    stats: typing.Optional[dict] = None,
) -> None:
    """Merge per-chip prediction rasters into one class GeoTIFF
    (reference ortho_segmentor.py:273-431).

    Per-class accumulation with a linear edge down-weighting ramp, scaled
    into ``count_dtype`` so at most ``max_overlapping_tiles`` chips can
    stack without overflow (more saturate at the dtype's maximum), then
    per-pixel argmax (the first maximum).  The counts, their argmax and
    their sum live on ``device`` (the card by default; raises without
    one); the files are the JAX package's, bit for bit.  Only the grid
    (shape, transform, EPSG) of ``raster_file`` is read.  A predicted
    value outside ``0..num_classes - 1`` that is not ``nodataval`` raises
    ``ValueError``.  ``stats``, when given, gets the seconds of reading
    the predictions (``read_s``), uploading them (``upload_s``), the
    device accumulation (``accumulate_s``), the argmax, nodata fill and
    sum (``argmax_s``), the download (``download_s``) and the files
    (``write_s``), and the counts tensor's ``counts_bytes``.
    """
    device = resolve_device(device, "assemble_tiled_predictions")
    count_dtype = np.dtype(count_dtype)
    if count_dtype not in _DEVICE_COUNT_DTYPES:
        raise ValueError(f"count_dtype {count_dtype}: one of "
                         f"{sorted(str(d) for d in _DEVICE_COUNT_DTYPES)}")
    timed = stats is not None

    def mark():
        if timed and device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    times = dict.fromkeys(("read_s", "upload_s", "accumulate_s"), 0.0)
    (h, w), _, _ = read_geotiff_grid(raster_file)
    windows = parse_windows_from_files([Path(f) for f in pred_files])
    top = int(np.iinfo(count_dtype).max)
    scale = top / max_overlapping_tiles
    counts = torch.zeros((h, w, num_classes), dtype=_DEVICE_COUNT_DTYPES[count_dtype],
                         device=device)
    observed = torch.zeros((h, w), dtype=torch.bool, device=device)
    bad = torch.zeros((), dtype=torch.bool, device=device)
    upload = PinnedUpload(device)
    weight_cache: dict = {}
    for f, window in zip(pred_files, windows):
        t0 = time.perf_counter()
        pred = _read_prediction(f, window)
        t1 = mark()
        r, c = window["row"], window["col"]
        hh, ww = window["height"], window["width"]
        key = (hh, ww)
        if key not in weight_cache:
            # float64 on the host, as the plain version rounds it
            scaled = (create_ramped_weighting(key, downweight_edge_frac) * scale
                      ).astype(count_dtype)
            weight_cache[key] = torch.as_tensor(scaled.astype(np.int64), device=device)
        scaled = weight_cache[key]
        pred_d = upload(pred).to(torch.int64)
        t2 = mark()
        valid = pred_d != nodataval
        bad |= (valid & ((pred_d < 0) | (pred_d >= num_classes))).any()
        idx = pred_d.clamp(0, num_classes - 1).unsqueeze(-1)
        block = counts[r:r + hh, c:c + ww]
        current = torch.gather(block, 2, idx).to(torch.int64)
        added = torch.clamp(current + scaled.unsqueeze(-1), max=top)
        block.scatter_(2, idx, torch.where(valid.unsqueeze(-1), added, current)
                       .to(counts.dtype))
        # ramp-zero border pixels contribute no counts: marking them
        # observed would argmax all-zero histograms to class 0 at the
        # mosaic border instead of nodata
        observed[r:r + hh, c:c + ww] |= valid & (scaled > 0)
        t3 = mark()
        times["read_s"] += t1 - t0
        times["upload_s"] += t2 - t1
        times["accumulate_s"] += t3 - t2
    if bool(bad):
        raise _out_of_range(f"one of the {len(windows)} predictions", num_classes,
                            nodataval)
    t0 = mark()
    classes = torch.argmax(counts, dim=-1).to(torch.uint8)
    classes[~observed] = nodataval
    counts_sum = None
    if counts_savefile is not None:
        counts_sum = (counts.sum(dim=-1, dtype=torch.int64) & 0xFFFF).to(torch.int32)
    t1 = mark()
    classes = classes.cpu().numpy()
    if counts_sum is not None:
        counts_sum = counts_sum.cpu().numpy().astype(np.uint16)
    t2 = time.perf_counter()
    _write_outputs(raster_file, classes, counts_sum, class_savefile, counts_savefile,
                   nodataval)
    if timed:
        stats.update(times, argmax_s=t1 - t0, download_s=t2 - t1,
                     write_s=time.perf_counter() - t2,
                     counts_bytes=counts.numel() * counts.element_size())


def assemble_tiled_predictions_plain(
    raster_file: PATH_TYPE,
    pred_files: typing.Sequence[PATH_TYPE],
    num_classes: int,
    class_savefile: PATH_TYPE,
    counts_savefile: typing.Optional[PATH_TYPE] = None,
    downweight_edge_frac: float = 0.25,
    nodataval: int = 255,
    count_dtype=np.uint8,
    max_overlapping_tiles: int = 4,
) -> None:
    """:func:`assemble_tiled_predictions` as the JAX package computes it:
    a numpy loop over chips and over each chip's classes on the host."""
    (h, w), _, _ = read_geotiff_grid(raster_file)
    windows = parse_windows_from_files([Path(f) for f in pred_files])

    scale = np.iinfo(count_dtype).max / max_overlapping_tiles
    counts = np.zeros((h, w, num_classes), dtype=count_dtype)
    observed = np.zeros((h, w), dtype=bool)

    weight_cache: dict = {}
    for f, window in zip(pred_files, windows):
        pred = _read_prediction(f, window)
        r, c = window["row"], window["col"]
        hh, ww = window["height"], window["width"]
        key = (hh, ww)
        if key not in weight_cache:
            weight_cache[key] = create_ramped_weighting(
                (hh, ww), downweight_edge_frac
            )
        weight = weight_cache[key]
        valid = pred != nodataval
        scaled = (weight * scale).astype(count_dtype)
        for cls in np.unique(pred[valid]):
            if not 0 <= cls < num_classes:
                raise _out_of_range(f"prediction {f}", num_classes, nodataval)
            mask = pred == cls
            block = counts[r : r + hh, c : c + ww, int(cls)]
            counts[r : r + hh, c : c + ww, int(cls)] = np.clip(
                block.astype(np.int64) + scaled * mask,
                0,
                np.iinfo(count_dtype).max,
            ).astype(count_dtype)
        observed[r : r + hh, c : c + ww] |= valid & (scaled > 0)

    classes = np.argmax(counts, axis=-1).astype(np.uint8)
    classes[~observed] = nodataval
    counts_sum = (None if counts_savefile is None
                  else counts.sum(axis=-1).astype(np.uint16))
    _write_outputs(raster_file, classes, counts_sum, class_savefile, counts_savefile,
                   nodataval)
