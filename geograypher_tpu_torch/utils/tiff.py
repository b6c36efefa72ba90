"""A baseline TIFF codec with the GeoTIFF tags, in numpy, ``zlib`` and
``struct``: the port's own in place of the PIL the JAX package reads and
writes GeoTIFFs with (``geograypher_tpu/utils/raster.py``).

Reader (:func:`read_tiff`): classic TIFF and BigTIFF (version 43: 8-byte
offsets and counts, 20-byte directory entries, the types LONG8, SLONG8
and IFD8) in either byte order, the first image of the file, stored in
strips or tiles, planar configuration 1 (samples interleaved); no
compression, deflate (zlib, codes 8 and 32946), LZW (5) and PackBits
(32773); horizontal predictor 2 on integer samples and the
floating-point predictor 3 on float samples (bytes differenced along
each row, after a shuffle into byte planes, most significant first);
unsigned and signed integers of 8, 16 and 32 bits and IEEE floats of 32
and 64 bits; one band, or 3-4 bands of uint8.  The file is mapped, not
read whole, so :func:`read_tiff_tags` reads a directory alone.  Tiles
and strips of a file decode in a few threads (``zlib`` releases the
interpreter lock).

Writer (:func:`write_tiff`): classic TIFF only; by default what PIL's
``Image.fromarray`` and ``save`` write for the JAX package, one
uncompressed strip with the same tags and the same conversions (int16 and
float64 as PIL stores them, as int32 and float32); optionally deflate,
tiles, predictor 2 and big-endian order.

Both carry the GeoTIFF tags (:func:`geo_tags_of`, :func:`geo_of_tags`): ModelPixelScale
(33550), ModelTiepoint (33922), ModelTransformation (34264), the
GeoKeyDirectory (34735) and GDAL_NODATA (42113).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import mmap
import os
import struct
import zlib
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

TAG_WIDTH = 256
TAG_HEIGHT = 257
TAG_BITS = 258
TAG_COMPRESSION = 259
TAG_PHOTOMETRIC = 262
TAG_STRIP_OFFSETS = 273
TAG_SAMPLES = 277
TAG_ROWS_PER_STRIP = 278
TAG_STRIP_BYTES = 279
TAG_PLANAR = 284
TAG_PREDICTOR = 317
TAG_TILE_WIDTH = 322
TAG_TILE_LENGTH = 323
TAG_TILE_OFFSETS = 324
TAG_TILE_BYTES = 325
TAG_EXTRA_SAMPLES = 338
TAG_SAMPLE_FORMAT = 339
TAG_MODEL_PIXEL_SCALE = 33550
TAG_MODEL_TIEPOINT = 33922
TAG_MODEL_TRANSFORM = 34264
TAG_GEO_KEY_DIRECTORY = 34735
TAG_GDAL_NODATA = 42113

COMPRESSION_NONE = 1
COMPRESSION_LZW = 5
COMPRESSION_DEFLATE = (8, 32946)
COMPRESSION_PACKBITS = 32773
THREADS = 8  # tiles or strips inflated / deflated at once
DEFLATE_LEVEL = 6

# TIFF field type -> struct code (and size); 16-18 are BigTIFF's LONG8,
# SLONG8 and IFD8
_TYPES = {1: "B", 2: "s", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h",
          9: "i", 10: "ii", 11: "f", 12: "d", 13: "I", 16: "Q", 17: "q", 18: "Q"}
_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8,
          13: 4, 16: 8, 17: 8, 18: 8}
# (sample format, bits) -> numpy kind
_KINDS = {(1, 8): "u1", (1, 16): "u2", (1, 32): "u4", (2, 8): "i1", (2, 16): "i2",
          (2, 32): "i4", (3, 32): "f4", (3, 64): "f8"}


@dataclasses.dataclass
class TiffImage:
    """The first image of a TIFF file: its samples ((H, W) or (H, W, C))
    and every tag of its directory (tag -> tuple of values, or a str for
    ASCII tags)."""

    data: np.ndarray
    tags: Dict[int, object]


@dataclasses.dataclass
class _Layout:
    """How a file's directory is laid out: classic TIFF (2-byte entry
    count, 12-byte entries, 4-byte values and offsets) or BigTIFF (8, 20,
    8)."""

    bo: str
    count: str = "H"
    offset: str = "I"

    @property
    def entry(self) -> int:
        return 4 + 2 * struct.calcsize(self.offset)


def _layout(buf, path) -> Tuple[_Layout, int]:
    """(the layout, the first directory's offset) of a file's header."""
    bo = {b"II": "<", b"MM": ">"}.get(bytes(buf[:2]))
    version = struct.unpack_from(bo + "H", buf, 2)[0] if bo and len(buf) >= 8 else None
    if version == 42:
        return _Layout(bo), struct.unpack_from(bo + "I", buf, 4)[0]
    if version == 43 and len(buf) >= 16:
        size, zero, first = struct.unpack_from(bo + "HHQ", buf, 4)
        if size == 8 and zero == 0:
            return _Layout(bo, "Q", "Q"), first
    raise ValueError(f"{path} is not a classic TIFF or BigTIFF file")


def _read_ifd(buf, lay: _Layout, offset: int) -> Dict[int, object]:
    bo, inline_size = lay.bo, struct.calcsize(lay.offset)
    (n,) = struct.unpack_from(bo + lay.count, buf, offset)
    first = offset + struct.calcsize(lay.count)
    tags = {}
    for k in range(n):
        tag, typ, count, inline = struct.unpack_from(
            f"{bo}HH{lay.offset}{inline_size}s", buf, first + lay.entry * k)
        if typ not in _TYPES:
            continue
        size = _SIZES[typ] * count
        if size <= inline_size:
            raw = inline[:size]
        else:
            (at,) = struct.unpack_from(bo + lay.offset, inline)
            raw = bytes(buf[at:at + size])
        if typ == 2:
            tags[tag] = raw.split(b"\x00")[0].decode("latin-1")
        elif typ in (5, 10):
            v = struct.unpack(bo + _TYPES[typ][0] * (2 * count), raw)
            tags[tag] = tuple(v[i] / v[i + 1] if v[i + 1] else float("nan")
                              for i in range(0, len(v), 2))
        else:
            tags[tag] = struct.unpack(bo + _TYPES[typ] * count, raw)
    return tags


def _lzw_decode(data: bytes) -> bytes:
    """TIFF LZW: most significant bit first, codes of 9 to 12 bits that
    widen one code early, 256 = clear, 257 = end of information."""
    out = bytearray()
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    width, bitpos, nbits = 9, 0, len(data) * 8
    prev = None
    padded = data + b"\x00\x00\x00"
    while bitpos + width <= nbits:
        at, shift = divmod(bitpos, 8)
        word = int.from_bytes(padded[at:at + 3], "big")
        code = (word >> (24 - shift - width)) & ((1 << width) - 1)
        bitpos += width
        if code == 257:
            break
        if code == 256:
            del table[258:]
            width, prev = 9, None
            continue
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        else:
            entry = prev + prev[:1]
            table.append(entry)
        out += entry
        prev = entry
        if len(table) + 1 >= (1 << width) and width < 12:
            width += 1
    return bytes(out)


def _packbits_decode(data: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        h = data[i]
        i += 1
        if h < 128:
            out += data[i:i + h + 1]
            i += h + 1
        elif h > 128:
            out += data[i:i + 1] * (257 - h)
            i += 1
    return bytes(out)


def _decompress(raw: bytes, compression: int) -> bytes:
    if compression == COMPRESSION_NONE:
        return raw
    if compression in COMPRESSION_DEFLATE:
        return zlib.decompress(raw)
    if compression == COMPRESSION_LZW:
        return _lzw_decode(raw)
    if compression == COMPRESSION_PACKBITS:
        return _packbits_decode(raw)
    raise ValueError(f"TIFF compression {compression} is not supported")


def _undo_float_predictor(raw: bytes, n_rows: int, width: int, spp: int,
                          dtype: np.dtype) -> np.ndarray:
    """(n_rows, width, spp) floats of a block stored with predictor 3:
    each row's bytes were split into byte planes (most significant
    first) and then differenced byte by byte with a stride of ``spp``."""
    size = dtype.itemsize
    b = np.frombuffer(raw[:n_rows * width * spp * size], np.uint8)
    b = np.cumsum(b.reshape(n_rows, width * size, spp), axis=1, dtype=np.uint8)
    planes = b.reshape(n_rows, size, width * spp).transpose(0, 2, 1)
    big = np.ascontiguousarray(planes).view(">" + dtype.kind + str(size))
    return big.reshape(n_rows, width, spp).astype(dtype.newbyteorder("="))


@contextlib.contextmanager
def _mapped(path):
    """The bytes of a file, mapped read-only for the ``with`` block (b""
    for an empty file, which cannot be mapped)."""
    with open(path, "rb") as fh:
        if os.fstat(fh.fileno()).st_size == 0:
            yield b""
            return
        with mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ) as buf:
            yield buf


def read_tiff_tags(path) -> Dict[int, object]:
    """The tags of the first image of a TIFF or BigTIFF file, without
    decoding its samples."""
    with _mapped(path) as buf:
        lay, first = _layout(buf, path)
        return _read_ifd(buf, lay, first)


def read_tiff(path) -> TiffImage:
    """The first image of a TIFF or BigTIFF file and its tags (see the
    module docstring for what is read)."""
    with _mapped(path) as buf:
        return _read_image(buf, path)


def _read_image(buf, path) -> TiffImage:
    lay, first = _layout(buf, path)
    bo = lay.bo
    tags = _read_ifd(buf, lay, first)
    w, h = int(tags[TAG_WIDTH][0]), int(tags[TAG_HEIGHT][0])
    spp = int(tags.get(TAG_SAMPLES, (1,))[0])
    bits = set(tags.get(TAG_BITS, (1,)))
    fmt = set(tags.get(TAG_SAMPLE_FORMAT, (1,)))
    if len(bits) != 1 or len(fmt) != 1:
        raise ValueError(f"mixed sample types {bits}, {fmt}")
    kind = _KINDS.get((fmt.pop(), bits.pop()))
    if kind is None:
        raise ValueError(f"unsupported samples: format {tags.get(TAG_SAMPLE_FORMAT)}, "
                         f"bits {tags.get(TAG_BITS)}")
    if spp > 1 and kind != "u1":
        raise ValueError(f"{spp} bands of {kind}: only one band, or uint8 bands")
    if int(tags.get(TAG_PLANAR, (1,))[0]) != 1:
        raise ValueError("only interleaved samples (PlanarConfiguration 1)")
    compression = int(tags.get(TAG_COMPRESSION, (1,))[0])
    predictor = int(tags.get(TAG_PREDICTOR, (1,))[0])
    is_float = kind[0] == "f"
    if not (predictor == 1 or (predictor == 2 and not is_float)
            or (predictor == 3 and is_float)):
        raise ValueError(f"predictor {predictor} on {kind} samples is not supported")
    dtype = np.dtype(bo + kind)
    if TAG_TILE_OFFSETS in tags:
        bw, bh = int(tags[TAG_TILE_WIDTH][0]), int(tags[TAG_TILE_LENGTH][0])
        offsets, counts = tags[TAG_TILE_OFFSETS], tags[TAG_TILE_BYTES]
        across = -(-w // bw)
        origins = [((k // across) * bh, (k % across) * bw) for k in range(len(offsets))]
    else:
        rows = min(int(tags.get(TAG_ROWS_PER_STRIP, (h,))[0]), h)
        bw, bh = w, rows
        offsets, counts = tags[TAG_STRIP_OFFSETS], tags[TAG_STRIP_BYTES]
        origins = [(k * rows, 0) for k in range(len(offsets))]
    out = np.empty((h, w, spp), dtype=dtype.newbyteorder("="))

    def block(k):
        r0, c0 = origins[k]
        n_rows = bh if TAG_TILE_OFFSETS in tags else min(bh, h - r0)
        raw = _decompress(bytes(buf[offsets[k]:offsets[k] + counts[k]]), compression)
        if predictor == 3:
            a = _undo_float_predictor(raw, n_rows, bw, spp, dtype)
        else:
            need = n_rows * bw * spp * dtype.itemsize
            a = np.frombuffer(raw[:need], dtype=dtype).reshape(n_rows, bw, spp)
            a = a.astype(dtype.newbyteorder("="))
        if predictor == 2:
            a = np.cumsum(a, axis=1, dtype=a.dtype)
        hh, ww = min(n_rows, h - r0), min(bw, w - c0)
        out[r0:r0 + hh, c0:c0 + ww] = a[:hh, :ww]

    with concurrent.futures.ThreadPoolExecutor(THREADS) as pool:
        list(pool.map(block, range(len(offsets))))
    return TiffImage(out[..., 0] if spp == 1 else out, tags)


# -- writing -------------------------------------------------------------------


def _as_pil_stores(data: np.ndarray) -> np.ndarray:
    """The samples as PIL's ``Image.fromarray`` + TIFF ``save`` store them:
    int16 as int32 and float64 as float32; uint8 bands of 3 or 4 as RGB /
    RGBA."""
    data = np.asarray(data)
    if data.ndim == 3 and not (data.dtype == np.uint8 and data.shape[2] in (3, 4)):
        raise ValueError(f"bands {data.shape} of {data.dtype}: only 3 or 4 uint8 bands")
    if data.ndim not in (2, 3):
        raise ValueError(f"a {data.ndim}-D array is not an image")
    conv = {np.dtype(np.int16): np.int32, np.dtype(np.float64): np.float32,
            np.dtype(np.int8): np.int32, np.dtype(np.uint32): None,
            np.dtype(bool): None, np.dtype(np.int64): None}
    if data.dtype in conv:
        if conv[data.dtype] is None:
            raise ValueError(f"{data.dtype} samples are not written")
        data = data.astype(conv[data.dtype])
    return data


def _entry(bo: str, tag: int, value) -> Tuple[int, int, int, bytes]:
    """(tag, type, count, packed bytes) of one directory entry."""
    if isinstance(value, str):
        raw = value.encode("latin-1") + b"\x00"
        return tag, 2, len(raw), raw
    typ, vals = value
    if typ == 12:
        return tag, 12, len(vals), struct.pack(bo + "d" * len(vals), *vals)
    return tag, typ, len(vals), struct.pack(bo + _TYPES[typ] * len(vals), *vals)


def write_tiff(
    path,
    data: np.ndarray,
    geo_tags: Optional[Dict[int, object]] = None,
    compression: str = "none",
    tile: Optional[Tuple[int, int]] = None,
    predictor: int = 1,
    byteorder: str = "<",
) -> None:
    """Write ``data`` as a one-image TIFF file.

    ``geo_tags``: extra tags, each ``(field type, values)`` or a str for
    an ASCII tag.  ``compression`` "none" or "deflate"; ``tile`` (width,
    height), multiples of 16, or None for strips (one strip when
    uncompressed, as PIL writes it, else strips of about 64 KiB);
    ``predictor`` 2 differences integer samples along rows.
    """
    data = _as_pil_stores(data)
    bo = byteorder
    h, w = data.shape[:2]
    spp = 1 if data.ndim == 2 else data.shape[2]
    kind = data.dtype.kind
    samples = data.reshape(h, w, spp)
    if predictor == 2 and kind == "f":
        raise ValueError("predictor 2 is for integer samples")
    compress = {"none": None,
                "deflate": lambda b: zlib.compress(b, DEFLATE_LEVEL)}[compression]
    if tile is not None:
        bw, bh = tile
        if bw % 16 or bh % 16:
            raise ValueError(f"tile {tile}: width and height must be multiples of 16")
        ty, tx = -(-h // bh), -(-w // bw)
        padded = np.zeros((ty * bh, tx * bw, spp), samples.dtype)
        padded[:h, :w] = samples
        blocks = [padded[i * bh:(i + 1) * bh, j * bw:(j + 1) * bw]
                  for i in range(ty) for j in range(tx)]
    else:
        stride = w * spp * data.dtype.itemsize
        rows = h if compress is None else max(1, min(65536 // max(stride, 1), h))
        blocks = [samples[r:r + rows] for r in range(0, h, rows)]
    def encode(b):
        if predictor == 2:  # differences along each block's rows
            b = np.concatenate([b[:, :1], np.diff(b, axis=1)], axis=1)
        raw = b.astype(b.dtype.newbyteorder(bo)).tobytes()
        return compress(raw) if compress else raw

    with concurrent.futures.ThreadPoolExecutor(THREADS) as pool:
        payloads = list(pool.map(encode, blocks))

    n = len(payloads)
    fmt = {"u": 1, "i": 2, "f": 3}[kind]
    bits = data.dtype.itemsize * 8
    tags = {
        TAG_WIDTH: (3 if w < 65536 else 4, (w,)),
        TAG_HEIGHT: (3 if h < 65536 else 4, (h,)),
        TAG_BITS: (3, (bits,) * spp),
        TAG_COMPRESSION: (3, (1 if compress is None else 8,)),
        TAG_PHOTOMETRIC: (3, (2 if spp >= 3 else 1,)),
        TAG_PLANAR: (3, (1,)),
    }
    if spp > 1:
        tags[TAG_SAMPLES] = (3, (spp,))
    if spp == 4:
        tags[TAG_EXTRA_SAMPLES] = (3, (2,))
    if fmt != 1:
        tags[TAG_SAMPLE_FORMAT] = (3, (fmt,) * spp)
    if predictor == 2:
        tags[TAG_PREDICTOR] = (3, (2,))
    if tile is not None:
        tags[TAG_TILE_WIDTH] = (3, (tile[0],))
        tags[TAG_TILE_LENGTH] = (3, (tile[1],))
        off_tag, cnt_tag = TAG_TILE_OFFSETS, TAG_TILE_BYTES
    else:
        tags[TAG_ROWS_PER_STRIP] = (4, (len(blocks[0]),))
        off_tag, cnt_tag = TAG_STRIP_OFFSETS, TAG_STRIP_BYTES
    tags[cnt_tag] = (4, tuple(len(p) for p in payloads))
    tags[off_tag] = (4, (0,) * n)
    tags.update(geo_tags or {})

    # layout: header, directory, the entries' values, then the samples
    order = sorted(tags)
    ifd_size = 2 + 12 * len(order) + 4
    values_at = 8 + ifd_size
    extra = bytearray()
    for _ in range(2):  # the second pass has the real sample offsets
        entries, extra = [], bytearray()
        for tag in order:
            t, typ, count, raw = _entry(bo, tag, tags[tag])
            if len(raw) <= 4:
                entries.append(struct.pack(bo + "HHI", t, typ, count) + raw.ljust(4, b"\x00"))
            else:
                if (values_at + len(extra)) % 2:
                    extra += b"\x00"
                at = values_at + len(extra)
                extra += raw
                entries.append(struct.pack(bo + "HHII", t, typ, count, at))
        data_at = values_at + len(extra)
        starts = np.concatenate([[0], np.cumsum([len(p) for p in payloads])[:-1]])
        tags[off_tag] = (4, tuple(int(data_at + s) for s in starts))
    header = (b"II" if bo == "<" else b"MM") + struct.pack(bo + "HI", 42, 8)
    ifd = struct.pack(bo + "H", len(order)) + b"".join(entries) + struct.pack(bo + "I", 0)
    with open(path, "wb") as fh:
        fh.write(header + ifd + bytes(extra))
        for p in payloads:
            fh.write(p)


def geo_tags_of(
    transform: Sequence[float],
    epsg: Optional[int],
    nodata: Optional[float],
) -> Dict[int, object]:
    """The GeoTIFF tags the JAX package's ``write_geotiff`` writes for a
    north-up affine ``transform`` (a, b, c, d, e, f)."""
    a, b, c, d, e, f = transform
    if abs(b) > 1e-12 or abs(d) > 1e-12:
        raise ValueError("write_geotiff only supports north-up affine")
    tags: Dict[int, object] = {
        TAG_MODEL_PIXEL_SCALE: (12, (float(a), float(-e), 0.0)),
        TAG_MODEL_TIEPOINT: (12, (0.0, 0.0, 0.0, float(c), float(f), 0.0)),
    }
    if epsg is not None:
        is_geo = int(epsg) == 4326
        key = KEY_GEOGRAPHIC_TYPE if is_geo else KEY_PROJECTED_CS_TYPE
        tags[TAG_GEO_KEY_DIRECTORY] = (3, (
            1, 1, 0, 2,
            KEY_GT_MODEL_TYPE, 0, 1, 2 if is_geo else 1,
            key, 0, 1, int(epsg),
        ))
    if nodata is not None:
        tags[TAG_GDAL_NODATA] = str(nodata)
    return tags


# GeoKey ids
KEY_GT_MODEL_TYPE = 1024
KEY_GEOGRAPHIC_TYPE = 2048
KEY_PROJECTED_CS_TYPE = 3072


def geo_of_tags(tags: Dict[int, object], height: int):
    """(transform, epsg, nodata) from a file's tags, as the JAX package's
    ``read_geotiff`` takes them: ModelTransformation over the pixel scale
    and tiepoint; the first projected EPSG of the key directory, else the
    last geographic one before it; GDAL_NODATA as a float."""
    if TAG_MODEL_TRANSFORM in tags:
        m = np.asarray(tags[TAG_MODEL_TRANSFORM], dtype=np.float64)
        transform = (m[0], m[1], m[3], m[4], m[5], m[7])
    elif TAG_MODEL_PIXEL_SCALE in tags and TAG_MODEL_TIEPOINT in tags:
        sx, sy = tags[TAG_MODEL_PIXEL_SCALE][:2]
        i0, j0, _, x0, y0, _ = tags[TAG_MODEL_TIEPOINT][:6]
        transform = (
            float(sx), 0.0, float(x0) - float(i0) * float(sx),
            0.0, -float(sy), float(y0) + float(j0) * float(sy),
        )
    else:
        transform = (1.0, 0.0, 0.0, 0.0, -1.0, float(height))
    epsg = None
    if TAG_GEO_KEY_DIRECTORY in tags:
        kd = list(tags[TAG_GEO_KEY_DIRECTORY])
        for k in range(4, len(kd), 4):
            key, loc, _, val = kd[k:k + 4]
            if key in (KEY_PROJECTED_CS_TYPE, KEY_GEOGRAPHIC_TYPE) and loc == 0:
                epsg = int(val)
                if key == KEY_PROJECTED_CS_TYPE:
                    break
    nodata = None
    if TAG_GDAL_NODATA in tags:
        try:
            nodata = float(str(tags[TAG_GDAL_NODATA]).strip("\x00 "))
        except ValueError:
            pass
    return transform, epsg, nodata
