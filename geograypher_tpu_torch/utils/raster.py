"""Georeferenced rasters: the port's own copy of
``geograypher_tpu/utils/raster.py`` on the port's TIFF codec
(``utils/tiff.py``) in place of PIL, and its area resize in place of cv2.

:class:`Raster` is an in-memory raster with a GDAL-style affine transform,
an EPSG code and a nodata value; it samples at world coordinates
(nearest, bilinear), reprojects by inverse warping and downsamples.
:func:`read_geotiff` / :func:`write_geotiff` read and write the GeoTIFF
tags the JAX package reads and writes:

* 33550 ModelPixelScaleTag, 33922 ModelTiepointTag (geotransform)
* 34264 ModelTransformationTag (full 4x4, read path)
* 34735 GeoKeyDirectoryTag (EPSG code)
* 42113 GDAL_NODATA

Only the north-up affine case is written, which is what the reference's
outputs use.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from geograypher_tpu_torch.constants import PATH_TYPE
from geograypher_tpu_torch.utils import crs as crs_utils
from geograypher_tpu_torch.utils import tiff
from geograypher_tpu_torch.utils.files import ensure_containing_folder
from geograypher_tpu_torch.utils.io import resize_area


@dataclasses.dataclass
class Raster:
    """An in-memory georeferenced raster.

    ``transform`` is the affine (a, b, c, d, e, f) mapping pixel (col, row)
    -> (x, y): x = a*col + b*row + c ; y = d*col + e*row + f  (GDAL-style,
    pixel edge origin).
    """

    data: np.ndarray  # (H, W) or (H, W, C)
    transform: Tuple[float, float, float, float, float, float]
    epsg: Optional[int] = None
    nodata: Optional[float] = None

    @property
    def shape(self):
        return self.data.shape

    @property
    def bounds(self) -> Tuple[float, float, float, float]:
        h, w = self.data.shape[:2]
        corners = np.array([[0, 0], [w, 0], [0, h], [w, h]], dtype=np.float64)
        xs, ys = self.pixel_to_world(corners[:, 0], corners[:, 1])
        return float(xs.min()), float(ys.min()), float(xs.max()), float(ys.max())

    def pixel_to_world(self, col, row):
        a, b, c, d, e, f = self.transform
        return a * col + b * row + c, d * col + e * row + f

    def world_to_pixel(self, x, y):
        a, b, c, d, e, f = self.transform
        det = a * e - b * d
        col = (e * (np.asarray(x) - c) - b * (np.asarray(y) - f)) / det
        row = (-d * (np.asarray(x) - c) + a * (np.asarray(y) - f)) / det
        return col, row

    def sample(self, xs, ys, method: str = "nearest"):
        """Sample raster values at world coordinates; NaN outside / nodata."""
        col, row = self.world_to_pixel(xs, ys)
        h, w = self.data.shape[:2]
        data = self.data.astype(np.float64)
        if self.nodata is not None:
            data = np.where(data == self.nodata, np.nan, data)
        if method == "nearest":
            ci = np.floor(col).astype(int)
            ri = np.floor(row).astype(int)
            ok = (ci >= 0) & (ci < w) & (ri >= 0) & (ri < h)
            out = np.full(
                np.shape(ci) + data.shape[2:], np.nan, dtype=np.float64
            )
            out[ok] = data[ri[ok], ci[ok]]
            return out
        if method == "bilinear":
            cf = col - 0.5
            rf = row - 0.5
            c0 = np.floor(cf).astype(int)
            r0 = np.floor(rf).astype(int)
            wc = cf - c0
            wr = rf - r0
            out = np.zeros(np.shape(c0) + data.shape[2:], dtype=np.float64)
            total = np.zeros(np.shape(c0), dtype=np.float64)
            for dc, dr, wt in (
                (0, 0, (1 - wc) * (1 - wr)),
                (1, 0, wc * (1 - wr)),
                (0, 1, (1 - wc) * wr),
                (1, 1, wc * wr),
            ):
                ci, ri = c0 + dc, r0 + dr
                ok = (ci >= 0) & (ci < w) & (ri >= 0) & (ri < h)
                val = np.where(
                    ok[..., None] if data.ndim == 3 else ok,
                    data[np.clip(ri, 0, h - 1), np.clip(ci, 0, w - 1)],
                    0.0,
                )
                good = ok & ~np.isnan(
                    val if data.ndim == 2 else val[..., 0]
                )
                out += np.where(
                    good[..., None] if data.ndim == 3 else good, val * (
                        wt[..., None] if data.ndim == 3 else wt
                    ), 0.0
                )
                total += np.where(good, wt, 0.0)
            with np.errstate(invalid="ignore", divide="ignore"):
                out = out / (total[..., None] if data.ndim == 3 else total)
            out[total == 0] = np.nan
            return out
        raise ValueError(f"Unknown sampling method {method}")

    def reprojected(
        self,
        dst_epsg: int,
        resolution: Optional[float] = None,
        method: str = "nearest",
    ) -> "Raster":
        """Resample this raster into another CRS (reference
        utils/geospatial.py:333-360 ``reproject_raster``).

        The destination grid is north-up, covering the reprojected corner
        bounds at ``resolution`` (defaults to the source pixel size
        expressed in destination units via the corner mapping).  Each
        destination pixel center is mapped BACK to the source CRS and
        sampled (inverse warping — no holes).
        """

        if self.epsg is None:
            raise ValueError("Raster has no CRS to reproject from")
        h, w = self.data.shape[:2]
        # reproject a corner+edge ring to bound the destination footprint
        cols = np.linspace(0, w, 9)
        rows = np.linspace(0, h, 9)
        ring_c = np.concatenate([cols, np.full(9, w), cols, np.zeros(9)])
        ring_r = np.concatenate([np.zeros(9), rows, np.full(9, h), rows])
        xs, ys = self.pixel_to_world(ring_c, ring_r)
        # rasters follow the GDAL axis order (x=easting/lon, y=northing/
        # lat) while transform_points uses pyproj's (lat, lon) columns
        # for geographic CRSs — swap on the way in and out
        src_geo = self.epsg in crs_utils.GEOGRAPHIC_EPSG
        dst_geo = dst_epsg in crs_utils.GEOGRAPHIC_EPSG
        pts = np.stack(
            ([ys, xs] if src_geo else [xs, ys]) + [np.zeros_like(xs)],
            axis=1,
        )
        dst = crs_utils.transform_points(pts, self.epsg, dst_epsg)
        if dst_geo:
            dst = dst[:, [1, 0, 2]]
        dx0, dy0 = dst[:, 0].min(), dst[:, 1].min()
        dx1, dy1 = dst[:, 0].max(), dst[:, 1].max()
        if resolution is None:
            # source pixel footprint in destination units
            src_res = float(
                np.hypot(self.transform[0], self.transform[3])
            ) or 1.0
            span_ratio = np.hypot(dx1 - dx0, dy1 - dy0) / max(
                np.hypot(*np.subtract(self.bounds[2:], self.bounds[:2])),
                1e-12,
            )
            resolution = src_res * span_ratio
        dw = max(int(np.ceil((dx1 - dx0) / resolution)), 1)
        dh = max(int(np.ceil((dy1 - dy0) / resolution)), 1)
        dcol, drow = np.meshgrid(
            np.arange(dw) + 0.5, np.arange(dh) + 0.5
        )
        dxs = dx0 + dcol * resolution
        dys = dy1 - drow * resolution
        bpts = np.stack(
            (
                [dys.ravel(), dxs.ravel()]
                if dst_geo
                else [dxs.ravel(), dys.ravel()]
            )
            + [np.zeros(dxs.size)],
            axis=1,
        )
        back = crs_utils.transform_points(bpts, dst_epsg, self.epsg)
        if src_geo:
            back = back[:, [1, 0, 2]]
        vals = self.sample(back[:, 0], back[:, 1], method=method)
        data = vals.reshape((dh, dw) + self.data.shape[2:])
        nodata = self.nodata
        if nodata is not None:
            # preserve the source dtype + nodata tag (integer class
            # rasters must stay integer: NaN.astype(int) is undefined)
            data = np.where(np.isnan(data), nodata, data).astype(
                self.data.dtype
            )
        elif not np.isnan(data).any():
            data = data.astype(self.data.dtype)
        return Raster(
            data,
            (resolution, 0.0, dx0, 0.0, -resolution, dy1),
            dst_epsg,
            nodata=nodata,
        )

    def downsampled(self, factor: int) -> "Raster":
        """Blockwise-subsampled raster (reference geospatial.py:362-392):
        an area resize by ``factor`` (``utils/io.py`` ``resize_area``, cv2's
        INTER_AREA; uint8 within +-1 of cv2's fixed point)."""
        h, w = self.data.shape[:2]
        data = resize_area(self.data, max(1, w // factor), max(1, h // factor))
        a, b, c, d, e, f = self.transform
        fx = w / data.shape[1]
        fy = h / data.shape[0]
        return Raster(
            data, (a * fx, b * fx, c, d * fy, e * fy, f), self.epsg, self.nodata
        )


def read_geotiff(path: PATH_TYPE) -> Raster:
    """A GeoTIFF file as a :class:`Raster` (the first image; its transform,
    EPSG and nodata from the GeoTIFF tags, as the JAX package reads them)."""
    img = tiff.read_tiff(path)
    transform, epsg, nodata = tiff.geo_of_tags(img.tags, img.data.shape[0])
    return Raster(data=img.data, transform=transform, epsg=epsg, nodata=nodata)


def read_geotiff_grid(path: PATH_TYPE):
    """((height, width), transform, epsg) of a GeoTIFF file's first image,
    from its tags alone: the grid :func:`read_geotiff` would give, without
    decoding the samples."""
    tags = tiff.read_tiff_tags(path)
    h = int(tags[tiff.TAG_HEIGHT][0])
    transform, epsg, _ = tiff.geo_of_tags(tags, h)
    return (h, int(tags[tiff.TAG_WIDTH][0])), transform, epsg


def write_geotiff(
    path: PATH_TYPE,
    raster: Raster,
    compression: str = "none",
    tile: Optional[Tuple[int, int]] = None,
) -> None:
    """Write a north-up :class:`Raster` as a GeoTIFF: by default the file
    the JAX package's PIL writer makes (one uncompressed strip, int16 and
    float64 stored as int32 and float32); ``compression="deflate"`` and
    ``tile=(width, height)`` for large rasters."""
    ensure_containing_folder(path)
    tags = tiff.geo_tags_of(raster.transform, raster.epsg, raster.nodata)
    tiff.write_tiff(path, raster.data, geo_tags=tags, compression=compression,
                    tile=tile)


def reproject_raster(
    input_filename: PATH_TYPE,
    output_filename: PATH_TYPE,
    dst_epsg: int,
    resolution: Optional[float] = None,
    method: str = "nearest",
) -> None:
    """File-level raster reprojection (reference utils/geospatial.py:333).

    Reads a GeoTIFF, resamples it into ``dst_epsg`` (see
    :meth:`Raster.reprojected`), writes the result.
    """
    write_geotiff(
        output_filename,
        read_geotiff(input_filename).reprojected(
            dst_epsg, resolution=resolution, method=method
        ),
    )
