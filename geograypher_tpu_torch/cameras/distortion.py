"""Lens-distortion engine: Brown-Conrady forward model and its inverse.

Port of ``geograypher_tpu/cameras/distortion.py``: the Metashape "Frame
Cameras" model (radial k1..k4, tangential p1/p2, affinity b1/b2) as plain
functions on float32 tensors of an explicit device, the inverse by 12
fixed-point steps per output pixel, the two (2, H, W) sampling maps of a
sensor, and resampling an image through a map: on the device
(:func:`remap_image_torch`, nearest neighbour, for pix2face maps) or on
the host in numpy (:func:`remap_image`, nearest neighbour or bilinear).

Semantics: the "ideal" image is the principal-point-free pinhole render;
cx/cy enter only through the warp.  With ``image_scale < 1`` the warp
runs on full-resolution pixel coordinates at a coarser step and its
results are scaled.

Two differences to the JAX package, both by construction.  XLA contracts
the polynomials into fused multiply-adds and torch does not, so the maps
agree to ~1e-4 px, not bit for bit.  The host bilinear remap is a plain
4-tap float32 interpolation; cv2's, which the JAX package calls,
quantises the fractional position to 1/32 px.  Nothing on the render
path takes the bilinear branch.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from geograypher_tpu_torch.utils.device import resolve_device


def distort_normalized(
    x: torch.Tensor, y: torch.Tensor, dist: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply Brown-Conrady distortion to normalized camera coords.

    Args:
        x, y: normalized coordinates ((pix - center) / f), any shape.
        dist: (8,) [k1, k2, k3, k4, p1, p2, b1, b2].

    Returns distorted normalized (xd, yd), before the affinity terms
    b1/b2, which apply at the pixel stage.
    """
    k1, k2, k3, k4, p1, p2 = (dist[i] for i in range(6))
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * (k3 + r2 * k4)))
    xd = x * radial + (p1 * (r2 + 2 * x * x) + 2 * p2 * x * y)
    yd = y * radial + (p2 * (r2 + 2 * y * y) + 2 * p1 * x * y)
    return xd, yd


def ideal_to_warped_pixels(
    xpix: torch.Tensor,
    ypix: torch.Tensor,
    f: torch.Tensor,
    cx: torch.Tensor,
    cy: torch.Tensor,
    image_width: int,
    image_height: int,
    dist: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ideal (pinhole, centered) pixel coords -> warped/distorted pixels:
    the ideal image's principal point is the geometric center, and
    cx/cy/b1/b2 apply on the way out."""
    x = (xpix - image_width / 2.0) / f
    y = (ypix - image_height / 2.0) / f
    xd, yd = distort_normalized(x, y, dist)
    b1, b2 = dist[6], dist[7]
    xpix_warp = image_width / 2.0 + cx + xd * f + xd * b1 + yd * b2
    ypix_warp = image_height / 2.0 + cy + yd * f
    return xpix_warp, ypix_warp


def warped_to_ideal_pixels(
    xpix_w: torch.Tensor,
    ypix_w: torch.Tensor,
    f: torch.Tensor,
    cx: torch.Tensor,
    cy: torch.Tensor,
    image_width: int,
    image_height: int,
    dist: torch.Tensor,
    iterations: int = 12,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Invert the Brown-Conrady warp by fixed-point iteration: find
    normalized (x, y) with distort(x, y) = (xd, yd) through the update
    ``x <- (target - tangential(x, y)) / radial(x, y)``, which converges
    for all realistic drone-lens coefficients."""
    b1, b2 = dist[6], dist[7]
    yd = (ypix_w - image_height / 2.0 - cy) / f
    # solve the affinity: xpix = W/2 + cx + xd*(f + b1) + yd*b2
    xd = (xpix_w - image_width / 2.0 - cx - yd * b2) / (f + b1)

    k1, k2, k3, k4, p1, p2 = (dist[i] for i in range(6))
    x, y = xd, yd
    for _ in range(iterations):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * (k3 + r2 * k4)))
        tx = p1 * (r2 + 2 * x * x) + 2 * p2 * x * y
        ty = p2 * (r2 + 2 * y * y) + 2 * p1 * x * y
        x, y = (xd - tx) / radial, (yd - ty) / radial
    return x * f + image_width / 2.0, y * f + image_height / 2.0


def make_maps(
    f,
    cx,
    cy,
    image_width: int,
    image_height: int,
    dist,
    image_scale: float = 1.0,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Build the (2, H, W) ideal->warped and warped->ideal sampling maps
    as float32 tensors on ``device`` (the card by default).

    A map's pixel position is the DESTINATION pixel and its value is the
    SOURCE (row, col) to sample.  So:

    * ``map_ideal_to_warped[..., i, j]`` = warped-image location sampled
      when producing ideal-image pixel (i, j), used to UNDISTORT.
    * ``map_warped_to_ideal[..., i, j]`` = ideal-image location sampled
      when producing warped-image pixel (i, j), used to re-DISTORT (e.g.
      warping a rendered pinhole pix2face to match the real image).

    With image_scale < 1, the warp runs over the full-res coordinate range
    at a coarser step and results scale down.
    """
    device = resolve_device(device, "make_maps")

    def scalar(v):
        return torch.as_tensor(v, dtype=torch.float32).to(device)

    f, cx, cy, dist = scalar(f), scalar(cx), scalar(cy), scalar(dist)
    out_h = int(image_height * image_scale)
    out_w = int(image_width * image_scale)
    if abs(image_scale - 1.0) < 1e-9:
        rr = torch.arange(image_height, dtype=torch.float32, device=device)
        cc = torch.arange(image_width, dtype=torch.float32, device=device)
    else:
        start = 1.0 / (2.0 * image_scale)
        step = 1.0 / image_scale
        rr = start + step * torch.arange(out_h, dtype=torch.float32, device=device)
        cc = start + step * torch.arange(out_w, dtype=torch.float32, device=device)
    rows, cols = torch.meshgrid(rr, cc, indexing="ij")

    wx, wy = ideal_to_warped_pixels(
        cols, rows, f, cx, cy, image_width, image_height, dist
    )
    ix, iy = warped_to_ideal_pixels(
        cols, rows, f, cx, cy, image_width, image_height, dist
    )
    s = scalar(image_scale)
    map_i2w = torch.stack([wy * s, wx * s], dim=0)
    map_w2i = torch.stack([iy * s, ix * s], dim=0)
    return map_i2w, map_w2i


def _nearest_gather(img: np.ndarray, map_y, map_x, fill_value) -> np.ndarray:
    h, w = img.shape[:2]
    ri = np.rint(map_y).astype(np.int64)
    ci = np.rint(map_x).astype(np.int64)
    inside = (ri >= 0) & (ri < h) & (ci >= 0) & (ci < w)
    out = np.full(map_x.shape + img.shape[2:], fill_value, dtype=img.dtype)
    out[inside] = img[ri[inside], ci[inside]]
    return out


def remap_image(
    image: np.ndarray,
    ijmap,
    fill_value: float = 0.0,
    interpolation_order: int = 1,
) -> np.ndarray:
    """Resample ``image`` through a (2, H, W) (row, col) source map, on
    the host in numpy; order 0 = nearest (discrete masks), 1 = bilinear.

    Integer images at order 0 take an exact gather (ids above 2^24 stay
    exact).  Other dtypes than uint8/float32/int16/uint16 are resampled
    in float32; integer dtypes are rounded back.  Sources outside the
    image read ``fill_value``; the bilinear branch blends it in at the
    border.
    """
    if isinstance(ijmap, torch.Tensor):
        ijmap = ijmap.cpu().numpy()
    ijmap = np.asarray(ijmap, dtype=np.float32)
    map_y, map_x = ijmap[0], ijmap[1]
    img = np.asarray(image)
    orig_dtype = img.dtype
    if interpolation_order == 0 and np.issubdtype(orig_dtype, np.integer):
        return _nearest_gather(img, map_y, map_x, fill_value)
    if img.dtype not in (np.uint8, np.float32, np.int16, np.uint16):
        img = img.astype(np.float32)
    if interpolation_order == 0:
        out = _nearest_gather(img, map_y, map_x, fill_value)
    else:
        out = _bilinear(img, map_y, map_x, fill_value)
    if np.issubdtype(orig_dtype, np.integer):
        out = np.round(out).astype(orig_dtype)
    return out


def bilinear_wrapped(img: np.ndarray, map_y, map_x) -> np.ndarray:
    """Bilinear remap whose columns wrap around (a panorama's longitude):
    a tap left of column 0 or right of the last column reads the other
    side, a tap above or below the image reads 0.  Dtypes as
    :func:`remap_image` takes them."""
    img = np.asarray(img)
    orig_dtype = img.dtype
    if img.dtype not in (np.uint8, np.float32, np.int16, np.uint16):
        img = img.astype(np.float32)
    out = _bilinear(img, np.asarray(map_y, np.float32),
                    np.asarray(map_x, np.float32), 0.0, wrap_cols=True)
    if np.issubdtype(orig_dtype, np.integer) and out.dtype != orig_dtype:
        out = np.round(out).astype(orig_dtype)
    return out


def _bilinear(img: np.ndarray, map_y, map_x, fill_value,
              wrap_cols: bool = False) -> np.ndarray:
    """4-tap float32 interpolation; a tap outside the image is
    ``fill_value``, or with ``wrap_cols`` a tap beside it reads the
    column modulo the width."""
    h, w = img.shape[:2]
    y0 = np.floor(map_y)
    x0 = np.floor(map_x)
    wy = (map_y - y0).astype(np.float32)
    wx = (map_x - x0).astype(np.float32)
    y0, x0 = y0.astype(np.int64), x0.astype(np.int64)
    extra = (1,) * (img.ndim - 2)

    def tap(yi, xi):
        if wrap_cols:
            xi = xi % w
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        vals = img[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)].astype(np.float32)
        return np.where(inside.reshape(inside.shape + extra), vals,
                        np.float32(fill_value))

    wy = wy.reshape(wy.shape + extra)
    wx = wx.reshape(wx.shape + extra)
    top = tap(y0, x0) * (1 - wx) + tap(y0, x0 + 1) * wx
    bottom = tap(y0 + 1, x0) * (1 - wx) + tap(y0 + 1, x0 + 1) * wx
    out = top * (1 - wy) + bottom * wy
    if img.dtype in (np.uint8, np.int16, np.uint16):
        info = np.iinfo(img.dtype)
        return np.clip(np.rint(out), info.min, info.max).astype(img.dtype)
    return out


def remap_image_torch(
    image: torch.Tensor, ijmap: torch.Tensor, fill_value: float = 0.0
) -> torch.Tensor:
    """Nearest-neighbor remap on the tensors' device (for pix2face maps
    that stay on the card); map values round half to even, as the JAX
    package's ``jnp.round`` does."""
    h, w = image.shape[:2]
    ri = torch.round(ijmap[0]).to(torch.int64)
    ci = torch.round(ijmap[1]).to(torch.int64)
    ok = (ri >= 0) & (ri < h) & (ci >= 0) & (ci < w)
    vals = image[ri.clamp(0, h - 1), ci.clamp(0, w - 1)]
    if vals.ndim > ok.ndim:
        ok = ok[..., None]
    fill = torch.full((), fill_value, dtype=image.dtype, device=image.device)
    return torch.where(ok, vals, fill)


class DistortionEngine:
    """Per-sensor cached distortion maps, built and kept on ``device``.

    Keyed by the parameters rounded to 8 decimals and the image scale, so
    cameras sharing a sensor share maps.
    """

    def __init__(self, device="cuda"):
        self.device = resolve_device(device, "DistortionEngine")
        self._maps: dict = {}

    @staticmethod
    def key(dist_vec: np.ndarray, f, cx, cy, w, h, image_scale: float) -> str:
        parts = [f"{float(v):.8f}" for v in np.asarray(dist_vec).ravel()]
        parts += [
            f"{float(f):.8f}", f"{float(cx):.8f}", f"{float(cy):.8f}",
            str(int(w)), str(int(h)), f"{float(image_scale):.8f}",
        ]
        return "|".join(parts)

    def clear(self) -> None:
        self._maps.clear()

    def get_maps(self, f, cx, cy, image_width, image_height, dist_vec,
                 image_scale: float = 1.0):
        """(ideal->warped, warped->ideal) maps as tensors on the engine's
        device."""
        k = self.key(dist_vec, f, cx, cy, image_width, image_height, image_scale)
        if k not in self._maps:
            self._maps[k] = make_maps(
                f, cx, cy, int(image_width), int(image_height),
                np.asarray(dist_vec, dtype=np.float32), float(image_scale),
                device=self.device,
            )
        return self._maps[k]

    def warp_dewarp_image(
        self,
        image: np.ndarray,
        f, cx, cy, image_width, image_height, dist_vec,
        warped_to_ideal: bool = True,
        fill_value: float = 0.0,
        interpolation_order: int = 1,
        image_scale: float = 1.0,
    ) -> np.ndarray:
        """Undistort (warped->ideal) or re-distort (ideal->warped) a host
        image."""
        i2w, w2i = self.get_maps(
            f, cx, cy, image_width, image_height, dist_vec, image_scale
        )
        ijmap = i2w if warped_to_ideal else w2i
        return remap_image(image, ijmap, fill_value, interpolation_order)

    def warp_dewarp_pixels(
        self,
        pixels_ij: np.ndarray,
        f, cx, cy, image_width, image_height, dist_vec,
        warped_to_ideal: bool = True,
    ) -> np.ndarray:
        """Map (N, 2) integer (i, j) pixel locations through the warp.
        Output is float (subpixel)."""
        i2w, w2i = self.get_maps(
            f, cx, cy, image_width, image_height, dist_vec, 1.0
        )
        # To transform warped pixel LOCATIONS to ideal ones, look up where
        # each warped pixel would be sampled FROM in the ideal image: that
        # is the warped->ideal *sampling* map (and vice versa).
        rowmap, colmap = (w2i if warped_to_ideal else i2w)
        pix = torch.as_tensor(np.asarray(pixels_ij), dtype=torch.int64,
                              device=self.device)
        out = torch.stack([rowmap[pix[:, 0], pix[:, 1]],
                           colmap[pix[:, 0], pix[:, 1]]], dim=1)
        return out.cpu().numpy()
