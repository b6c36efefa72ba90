"""Image / array IO: the port's ``read_image_or_numpy`` and ``write_image``
(``geograypher_tpu/utils/io.py``) on a PNG codec of its own.

The codec needs ``zlib``, ``struct`` and numpy only.  It writes 8-bit
gray, 8-bit RGB / RGBA and 16-bit gray images, non-interlaced, every row
with filter type 0 (None), and reads non-interlaced 8- and 16-bit gray,
gray + alpha, RGB and RGBA files of every filter type (0-4, mixed from
row to row as PIL and libpng choose them).  Any other file (palettes,
interlacing, other bit depths, other formats) goes to ``imageio`` when
that is importable; without it the read raises and names the file.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

from geograypher_tpu_torch.constants import PATH_TYPE
from geograypher_tpu_torch.utils.files import ensure_containing_folder
from geograypher_tpu_torch.utils.profiling import annotate

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# channels of the PNG colour types the codec handles: gray, RGB,
# gray + alpha, RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
#: zlib level of ``write_image``: label masks are long runs, which level 1
#: already packs to a fraction of a percent, several times faster than 6
PNG_ZLIB_LEVEL = 1


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def encode_png(image: np.ndarray, level: int = PNG_ZLIB_LEVEL) -> bytes:
    """The bytes of a PNG file holding ``image``: (H, W) or (H, W, 1)
    uint8 / uint16 gray, (H, W, 3) uint8 RGB or (H, W, 4) uint8 RGBA.
    Rows carry filter type 0."""
    img = np.asarray(image)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.dtype == np.bool_:
        img = img.astype(np.uint8) * 255
    if img.ndim == 2 and img.dtype in (np.uint8, np.uint16):
        color_type = 0
    elif img.ndim == 3 and img.shape[2] in (3, 4) and img.dtype == np.uint8:
        color_type = 2 if img.shape[2] == 3 else 6
    else:
        raise ValueError(
            f"cannot write a {img.dtype} array of shape {img.shape} as PNG: "
            "supported are uint8/uint16 (H, W) and uint8 (H, W, 3|4)"
        )
    h, w = img.shape[:2]
    file_dtype = img.dtype.newbyteorder(">")  # uint8 keeps its dtype
    depth = 8 * file_dtype.itemsize
    # the filter byte and the rows in one buffer, filled by one copy (a
    # byte swap for native uint16) that releases the GIL, and handed to
    # zlib as it is: mask writers encode on several threads at once
    raw = np.empty((h, 1 + img[0].size * file_dtype.itemsize), np.uint8)
    raw[:, 0] = 0  # filter type None
    rows = raw[:, 1:].view(file_dtype).reshape(img.shape)
    np.copyto(rows, img, casting="equiv")
    header = struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw, level))
            + _chunk(b"IEND", b""))


def _skewed(m: int, w: int, bpp: int):
    """(flat, view): an int16 buffer of the anti-diagonals of an
    (m, w, bpp) block and the row above it, and its (m + 1, w, bpp) view
    in row order.  Pixel (r, x), r = 0 the row above, sits on diagonal
    ``d = r + x`` at position ``r`` of it, ``flat[d * (m + 1) + r]``, so
    every diagonal is one contiguous slice; the other positions are 0."""
    flat = np.zeros(((m + w) * (m + 1), bpp), np.int16)
    step = flat.strides[0]
    view = np.lib.stride_tricks.as_strided(
        flat, shape=(m + 1, w, bpp), strides=((m + 2) * step, (m + 1) * step, 2))
    return flat, view


def _unfilter_wavefront(rows: np.ndarray, filters: np.ndarray, above: np.ndarray):
    """Reconstruct (m, w, bpp) filtered bytes in place, every row by its own
    filter type (0-4), given the reconstructed row ``above`` the first.

    A byte depends on the reconstructed bytes of the pixel to its left, the
    one above and the one above-left, so the pixels of an anti-diagonal
    (row + column constant) depend only on the two diagonals before it:
    each diagonal is one vectorised step over the rows (:func:`_skewed`).
    Positions left of column 0 stay zero, which is what the filters read
    there.
    """
    m, w, bpp = rows.shape
    n = m + 1  # positions on a diagonal
    out, out_rows = _skewed(m, w, bpp)
    resid, resid_rows = _skewed(m, w, bpp)
    out_rows[0] = above
    resid_rows[1:] = rows
    kind = np.concatenate([[0], filters]).astype(np.intp)[:, None]
    zeros = np.zeros((n, bpp), np.int16)
    for d in range(1, m + w):
        lo, hi = max(1, d - w + 1), min(m, d)  # rows on the diagonal
        a = out[(d - 1) * n + lo:(d - 1) * n + hi + 1]  # left
        b = out[(d - 1) * n + lo - 1:(d - 1) * n + hi]  # up
        c = out[(d - 2) * n + lo - 1:(d - 2) * n + hi] if d > 1 else zeros[:hi - lo + 1]
        ab = a + b
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(ab - 2 * c)
        paeth = np.where(pa <= np.minimum(pb, pc), a, np.where(pb <= pc, b, c))
        pred = np.choose(kind[lo:hi + 1], (zeros[:hi - lo + 1], a, b, ab >> 1, paeth))
        np.bitwise_and(resid[d * n + lo:d * n + hi + 1] + pred, 0xFF,
                       out=out[d * n + lo:d * n + hi + 1])
    rows[...] = out_rows[1:]


def decode_png(data: bytes) -> Optional[np.ndarray]:
    """The image of a PNG file's bytes, or None when the file uses what
    the codec does not read (a palette, interlacing, a bit depth other
    than 8 or 16).  Raises ``ValueError`` for bytes that are not a PNG
    file at all.

    Rows of filter types 0-2 before the first row of type 3 (Average) or
    4 (Paeth) decode row-wise (a ``cumsum`` for Sub, a sum with the row
    above for Up); from that row on, :func:`_unfilter_wavefront` decodes
    every row by its own type.
    """
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack_from(">I4s", data, pos)
        payload = data[pos + 8: pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG file without a header")
    w, h, depth, color_type, _, _, interlace = header
    if color_type not in _PNG_CHANNELS or depth not in (8, 16) or interlace:
        return None
    channels = _PNG_CHANNELS[color_type]
    bpp = channels * depth // 8  # bytes per pixel
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError("PNG data does not match its header")
    raw = raw.reshape(h, 1 + w * bpp)
    filters = raw[:, 0]
    if (filters > 4).any():
        raise ValueError(f"PNG filter type {int(filters.max())} does not exist")
    rows = raw[:, 1:].copy()
    pixels = rows.reshape(h, w, bpp)
    late = np.flatnonzero(filters > 2)
    first_late = int(late[0]) if late.size else h
    for y in np.flatnonzero(filters[:first_late]):
        if filters[y] == 1:  # Sub: each byte adds the pixel to its left
            np.cumsum(pixels[y], axis=0, dtype=np.uint8, out=pixels[y])
        elif y:  # Up: each byte adds the one above (zeros above row 0)
            rows[y] += rows[y - 1]
    if late.size:
        above = pixels[first_late - 1] if first_late else np.zeros((w, bpp), np.uint8)
        _unfilter_wavefront(pixels[first_late:], filters[first_late:], above)
    out = rows.view(np.dtype(">u2") if depth == 16 else np.uint8)
    out = out.astype(np.uint16 if depth == 16 else np.uint8)
    return out.reshape(h, w) if channels == 1 else out.reshape(h, w, channels)


def read_image_or_numpy(filename: PATH_TYPE) -> np.ndarray:
    """Read an image file or .npy array.  PNG and TIFF files go through the
    port's own decoders (``utils/tiff.py`` for TIFF); what they do not
    read (JPEG among others) goes to ``imageio`` when that is installed."""
    filename = Path(filename)
    suffix = filename.suffix.lower()
    if suffix == ".npy":
        return np.load(filename)
    if suffix == ".png":
        image = decode_png(filename.read_bytes())
        if image is not None:
            return image
    if suffix in (".tif", ".tiff"):
        from geograypher_tpu_torch.utils.tiff import read_tiff

        try:
            return read_tiff(filename).data
        except ValueError:
            pass
    try:
        import imageio.v3 as iio
    except ImportError:
        raise ValueError(
            f"cannot read {filename}: the built-in decoder reads non-interlaced "
            "8/16-bit gray, gray + alpha, RGB and RGBA PNG files, and imageio "
            "is not installed for anything else"
        ) from None
    return np.asarray(iio.imread(filename))


def write_image(filename: PATH_TYPE, image: np.ndarray,
                level: int = PNG_ZLIB_LEVEL) -> int:
    """Write ``image`` as .npy or .png (see :func:`encode_png` for the
    array kinds a PNG takes); returns the number of bytes written."""
    filename = ensure_containing_folder(filename)
    suffix = filename.suffix.lower()
    if suffix == ".npy":
        with annotate("io.write"):
            np.save(filename, image)
        return filename.stat().st_size
    if suffix != ".png":
        raise ValueError(f"cannot write {filename}: only .png and .npy are written")
    with annotate("io.encode"):
        data = encode_png(image, level)
    with annotate("io.write"):
        filename.write_bytes(data)
    return len(data)


def resize_nearest(image: np.ndarray, width: int, height: int) -> np.ndarray:
    """Nearest-neighbour resize by an index gather, pixel for pixel what
    ``cv2.resize(image, (width, height), interpolation=cv2.INTER_NEAREST)``
    gives: ``src = min(floor(dst * src_size / dst_size), src_size - 1)``."""
    image = np.asarray(image)
    rows = nearest_indices(image.shape[0], height)
    cols = nearest_indices(image.shape[1], width)
    return image[rows[:, None], cols[None, :]]


def nearest_indices(src_size: int, dst_size: int) -> np.ndarray:
    """(dst_size,) source index of every destination index of a
    nearest-neighbour resize."""
    scale = src_size / dst_size
    idx = np.floor(np.arange(dst_size) * scale).astype(np.int64)
    return np.minimum(idx, src_size - 1)


def _area_taps(src_size: int, dst_size: int):
    """(indices, weights), each (dst_size, K): the source pixels every
    destination pixel of an area-averaging downscale covers, and the
    share of its cell each takes."""
    scale = src_size / dst_size
    lo = np.arange(dst_size) * scale
    hi = np.minimum(lo + scale, src_size)
    first = np.floor(lo).astype(np.int64)
    taps = int(np.ceil(scale)) + 1
    idx = first[:, None] + np.arange(taps)[None, :]
    cover = np.minimum(idx + 1, hi[:, None]) - np.maximum(idx, lo[:, None])
    weights = np.clip(cover, 0.0, None) / (hi - lo)[:, None]
    return np.minimum(idx, src_size - 1), weights.astype(np.float32)


def _area_linear_taps(src_size: int, dst_size: int):
    """(indices, weights), each (dst_size, 2): the two source pixels and
    their weights of cv2's INTER_AREA along an axis of a resize that
    enlarges on some axis, where cv2 interpolates linearly with the area
    rule's fractions (``resize.cpp``: ``sx = floor(dx * scale)``,
    ``fx = (dx + 1) - (sx + 1) / scale`` when positive, else 0, taken
    modulo 1; the last pixel clamps)."""
    scale = src_size / dst_size
    inv_scale = dst_size / src_size
    dx = np.arange(dst_size)
    sx = np.floor(dx * scale).astype(np.int64)
    fx = ((dx + 1) - (sx + 1) * inv_scale).astype(np.float32)
    fx = np.where(fx <= 0, np.float32(0), fx - np.floor(fx)).astype(np.float32)
    last = sx >= src_size - 1
    fx = np.where(last, np.float32(0), fx)
    sx = np.minimum(sx, src_size - 1)
    idx = np.stack([sx, np.minimum(sx + 1, src_size - 1)], axis=1)
    return idx, np.stack([1 - fx, fx], axis=1).astype(np.float32)


def _linear_taps(src_size: int, dst_size: int):
    """cv2's INTER_LINEAR taps: the source position ``(d + 0.5) * scale -
    0.5`` between its two neighbours, held at the first and last pixel."""
    scale = src_size / dst_size
    fx = (np.arange(dst_size) + 0.5) * scale - 0.5
    sx = np.floor(fx).astype(np.int64)
    fx = fx - sx
    low = sx < 0
    high = sx >= src_size - 1
    fx = np.where(low | high, 0.0, fx)
    sx = np.where(low, 0, np.where(high, src_size - 1, sx))
    idx = np.stack([sx, np.minimum(sx + 1, src_size - 1)], axis=1)
    return idx, np.stack([1 - fx, fx], axis=1).astype(np.float32)


def _resize_separable(image: np.ndarray, width: int, height: int, taps) -> np.ndarray:
    """Resize by ``taps(src, dst) -> (indices, weights)`` along rows, then
    columns, in float32; integer images are rounded back to their dtype."""
    image = np.asarray(image)
    h, w = image.shape[:2]
    out = image.astype(np.float32)
    for axis, (src, dst) in enumerate(((h, height), (w, width))):
        if src == dst:
            continue
        idx, weights = taps(src, dst)
        shape = [1] * out.ndim
        shape[axis] = dst
        acc = 0.0
        for k in range(idx.shape[1]):
            acc = acc + np.take(out, idx[:, k], axis=axis) * weights[:, k].reshape(shape)
        out = acc
    if np.issubdtype(image.dtype, np.integer):
        info = np.iinfo(image.dtype)
        return np.clip(np.rint(out), info.min, info.max).astype(image.dtype)
    return out.astype(image.dtype) if image.dtype == np.float64 else out


def resize_linear(image: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(image, (width, height))`` (``INTER_LINEAR``, cv2's
    default) without cv2: every destination pixel interpolates between the
    two source pixels around its centre on each axis, in float32.  uint8
    agrees with cv2 to +-1 (cv2 weighs in fixed point)."""
    return _resize_separable(image, width, height, _linear_taps)


def resize_area(image: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(image, (width, height), interpolation=cv2.INTER_AREA)``
    without cv2.  When neither axis grows, every destination pixel is the
    mean of the source area it covers, fractional pixels weighted by their
    share; when one axis grows, both axes interpolate linearly between two
    source pixels with cv2's area-mode fractions.  Integer images are
    rounded back to their dtype (uint8 agrees with cv2 to +-1, which works
    in fixed point; float32 to ~1e-6).
    """
    h, w = np.asarray(image).shape[:2]
    taps = _area_taps if width <= w and height <= h else _area_linear_taps
    return _resize_separable(image, width, height, taps)
