"""The port's TIFF codec and GeoTIFF rasters (``utils/tiff.py``,
``utils/raster.py``) against PIL and the JAX package's ``utils/raster.py``.

Files go both ways: what the JAX package (PIL) writes the port reads to
the same ``Raster`` (data bit for bit, transform, EPSG, nodata), and what
the port writes the JAX package reads the same.  Sampling, reprojection
and downsampling are held against the JAX package's: nearest and bilinear
samples and reprojected grids exactly, ``downsampled`` to float32
rounding (cv2's INTER_AREA against ``resize_area``, rtol 1e-6) and to +-1
on uint8 (ROADMAP C4)."""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image
from PIL.TiffImagePlugin import ImageFileDirectory_v2

from geograypher_tpu.utils import raster as jr
from geograypher_tpu_torch.utils import raster as tr
from geograypher_tpu_torch.utils import tiff
from tests.test_torch_rasterize import one_torch_thread  # noqa: F401

DTYPES = [np.uint8, np.uint16, np.int16, np.int32, np.float32, np.float64]
# what PIL stores (and the port writes) for each
STORED = {np.dtype(np.int16): np.int32, np.dtype(np.float64): np.float32}


def _samples(dtype, shape=(37, 53), seed=0):
    rng = np.random.default_rng(seed)
    a = rng.random(shape) * 250
    if np.dtype(dtype).kind == "i":
        a -= 100
    return a.astype(dtype)


def _same_raster(a, b):
    assert a.data.dtype == b.data.dtype and a.data.shape == b.data.shape
    np.testing.assert_array_equal(a.data, b.data)
    assert tuple(a.transform) == tuple(b.transform)
    assert a.epsg == b.epsg and a.nodata == b.nodata


@pytest.mark.parametrize("compression", ["raw", "tiff_lzw", "tiff_deflate",
                                         "tiff_adobe_deflate", "packbits"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int32, np.float32, "rgb",
                                   "rgba"])
def test_reads_what_pil_writes(tmp_path, compression, dtype):
    """Strips of every compression PIL writes, one band or uint8 RGB(A):
    the port reads PIL's own reading of the file, bit for bit."""
    if dtype in ("rgb", "rgba"):
        data = _samples(np.uint8, (29, 41, 3 if dtype == "rgb" else 4))
    else:
        data = _samples(dtype)
    path = tmp_path / "a.tif"
    Image.fromarray(data).save(path, compression=compression)
    got = tiff.read_tiff(path).data
    want = np.asarray(Image.open(path))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("byteorder", ["<", ">"])
@pytest.mark.parametrize("layout", [dict(), dict(compression="deflate"),
                                    dict(tile=(32, 16)),
                                    dict(compression="deflate", tile=(64, 32))])
@pytest.mark.parametrize("dtype", DTYPES)
def test_writer_round_trips(tmp_path, dtype, layout, byteorder):
    """The port's writer in strips or tiles, raw or deflate (integers with
    predictor 2 there), either byte order: its reader gives the samples
    back as PIL stores them; PIL reads the same where it reads the file
    (it misreads big-endian 32-bit samples inflated by libtiff)."""
    data = _samples(dtype, (45, 70))
    pred = 2 if layout.get("compression") and np.dtype(dtype).kind != "f" else 1
    path = tmp_path / "w.tif"
    tiff.write_tiff(path, data, predictor=pred, byteorder=byteorder, **layout)
    want = data.astype(STORED.get(np.dtype(dtype), dtype))
    got = tiff.read_tiff(path).data
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if byteorder == "<" or not layout.get("compression") or want.itemsize < 4:
        np.testing.assert_array_equal(np.asarray(Image.open(path)), want)


def test_lzw_with_predictor_and_tiles_from_pil(tmp_path):
    """libtiff's LZW with horizontal differencing in tiles."""
    data = _samples(np.uint16, (70, 90))
    path = tmp_path / "t.tif"
    Image.fromarray(data).save(path, compression="tiff_lzw",
                               tiffinfo={317: 2, 322: 32, 323: 32})
    im = Image.open(path)
    np.testing.assert_array_equal(tiff.read_tiff(path).data, np.asarray(im))


@pytest.mark.parametrize("nodata", [None, -9999.0, 255.0])
@pytest.mark.parametrize("epsg", [32611, 4326, None])
@pytest.mark.parametrize("dtype", DTYPES)
def test_geotiffs_round_trip_both_ways(tmp_path, dtype, epsg, nodata):
    """A raster written by the JAX package (PIL) reads as the same Raster
    in both packages, and one written by the port reads the same in both:
    data, transform, EPSG (projected and geographic keys) and nodata."""
    data = _samples(dtype)
    transform = (0.5, 0.0, 500100.25, 0.0, -0.25, 4000200.75)
    jr.write_geotiff(tmp_path / "j.tif", jr.Raster(data, transform, epsg, nodata))
    tr.write_geotiff(tmp_path / "t.tif", tr.Raster(data, transform, epsg, nodata))
    for name in ("j.tif", "t.tif"):
        _same_raster(tr.read_geotiff(tmp_path / name), jr.read_geotiff(tmp_path / name))
    _same_raster(tr.read_geotiff(tmp_path / "t.tif"), tr.read_geotiff(tmp_path / "j.tif"))
    got = tr.read_geotiff(tmp_path / "t.tif")
    np.testing.assert_array_equal(got.data, data.astype(STORED.get(np.dtype(dtype), dtype)))


def _pil_with_tags(path, data, tags):
    ifd = ImageFileDirectory_v2()
    for tag, value in tags.items():
        ifd[tag] = value
    Image.fromarray(data).save(path, tiffinfo=ifd)


@pytest.mark.parametrize("keys", [
    (2048, 4326, 3072, 32610),  # geographic before projected: projected
    (3072, 32611, 2048, 4269),  # projected first: it
    (2048, 4269, 2048, 4326),   # two geographic: the last
    (1024, 1, 3076, 9001),      # neither: no EPSG
])
def test_geokey_directory_gives_the_jax_epsg(tmp_path, keys):
    """The key directory read as the JAX package reads it: the first
    projected EPSG, else the last geographic one; keys stored elsewhere
    (location != 0) skipped."""
    kd = (1, 1, 0, 3, 1024, 0, 1, 1, keys[0], 0, 1, keys[1], keys[2], 0, 1, keys[3])
    path = tmp_path / "k.tif"
    _pil_with_tags(path, _samples(np.float32), {
        tiff.TAG_MODEL_PIXEL_SCALE: (1.0, 1.0, 0.0),
        tiff.TAG_MODEL_TIEPOINT: (0.0, 0.0, 0.0, 10.0, 20.0, 0.0),
        tiff.TAG_GEO_KEY_DIRECTORY: kd})
    _same_raster(tr.read_geotiff(path), jr.read_geotiff(path))


def test_model_transformation_and_tiepoint_offsets(tmp_path):
    """A full ModelTransformation (rotated) and a tiepoint away from pixel
    (0, 0) give the JAX package's transform; no geo tags its default."""
    m = (0.5, 0.1, 0.0, 300.0, 0.05, -0.5, 0.0, 900.0,
         0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0)
    _pil_with_tags(tmp_path / "m.tif", _samples(np.float32), {tiff.TAG_MODEL_TRANSFORM: m})
    _pil_with_tags(tmp_path / "p.tif", _samples(np.float32), {
        tiff.TAG_MODEL_PIXEL_SCALE: (2.0, 3.0, 0.0),
        tiff.TAG_MODEL_TIEPOINT: (4.0, 5.0, 0.0, 100.0, 200.0, 0.0),
        tiff.TAG_GDAL_NODATA: " -32768 "})
    Image.fromarray(_samples(np.uint8)).save(tmp_path / "n.tif")
    for name in ("m.tif", "p.tif", "n.tif"):
        _same_raster(tr.read_geotiff(tmp_path / name), jr.read_geotiff(tmp_path / name))
    assert tr.read_geotiff(tmp_path / "p.tif").nodata == -32768.0


def test_tiled_deflate_geotiff_reads_in_the_jax_package(tmp_path):
    """A large-raster layout of the port's writer (deflate, 256^2 tiles)
    is a GeoTIFF PIL reads to the same Raster."""
    data = _samples(np.float32, (300, 520))
    r = tr.Raster(data, (0.25, 0.0, 10.0, 0.0, -0.25, 50.0), 32611, -1.0)
    tr.write_geotiff(tmp_path / "d.tif", r, compression="deflate", tile=(256, 256))
    _same_raster(tr.read_geotiff(tmp_path / "d.tif"), jr.read_geotiff(tmp_path / "d.tif"))
    assert tiff.read_tiff(tmp_path / "d.tif").tags[tiff.TAG_TILE_WIDTH] == (256,)


def test_reader_refuses_what_it_does_not_read(tmp_path):
    (tmp_path / "x.tif").write_bytes(b"II+\x00" + bytes(12))
    with pytest.raises(ValueError, match="not a classic TIFF"):
        tiff.read_tiff(tmp_path / "x.tif")
    with pytest.raises(ValueError, match="north-up"):
        tr.write_geotiff(tmp_path / "r.tif", tr.Raster(np.zeros((2, 2), np.float32),
                                                       (1, 0.5, 0, 0, -1, 0)))
    with pytest.raises(ValueError, match="bands"):
        tiff.write_tiff(tmp_path / "b.tif", np.zeros((4, 4, 3), np.float32))


def _predictor3_tiff(path, data, tile=None, byteorder="<", rows_per_strip=7):
    """A deflate TIFF of one band of floats with the floating-point
    predictor (3), built by hand as libtiff writes it: each row's bytes
    shuffled into byte planes, most significant first, then differenced
    byte by byte."""
    bo = byteorder
    h, w = data.shape
    size = data.dtype.itemsize

    def encode(block):
        n, bw = block.shape
        planes = np.ascontiguousarray(block.astype(f">f{size}")).view(np.uint8)
        rows = planes.reshape(n, bw, size).transpose(0, 2, 1).reshape(n, bw * size)
        return zlib.compress(np.diff(rows, axis=1, prepend=0).astype(np.uint8).tobytes())

    if tile is None:
        blocks = [encode(data[r:r + rows_per_strip]) for r in range(0, h, rows_per_strip)]
        layout = [(273, "offsets"), (278, [rows_per_strip]), (279, "counts")]
    else:
        tw, th = tile
        padded = np.zeros((-(-h // th) * th, -(-w // tw) * tw), data.dtype)
        padded[:h, :w] = data
        blocks = [encode(padded[i:i + th, j:j + tw])
                  for i in range(0, padded.shape[0], th)
                  for j in range(0, padded.shape[1], tw)]
        layout = [(322, [tw]), (323, [th]), (324, "offsets"), (325, "counts")]
    entries = dict([(256, [w]), (257, [h]), (258, [8 * size]), (259, [8]), (262, [1]),
                    (277, [1]), (284, [1]), (317, [3]), (339, [3])] + layout)
    n_tags = len(entries)
    extra_at = 8 + 2 + 12 * n_tags + 4
    arrays = [t for t, v in entries.items() if isinstance(v, str) or len(v) > 1]
    data_at = extra_at + 4 * len(blocks) * len(arrays)
    starts = data_at + np.concatenate([[0], np.cumsum([len(b) for b in blocks])[:-1]])
    entries = {t: ([int(x) for x in starts] if v == "offsets" else
                   [len(b) for b in blocks] if v == "counts" else v)
               for t, v in entries.items()}
    ifd, extra = b"", b""
    for tag in sorted(entries):
        vals = entries[tag]
        raw = struct.pack(bo + "I" * len(vals), *vals)
        if len(raw) <= 4:
            ifd += struct.pack(bo + "HHI", tag, 4, len(vals)) + raw
        else:
            ifd += struct.pack(bo + "HHII", tag, 4, len(vals), extra_at + len(extra))
            extra += raw
    head = (b"II" if bo == "<" else b"MM") + struct.pack(bo + "HI", 42, 8)
    out = head + struct.pack(bo + "H", n_tags) + ifd + struct.pack(bo + "I", 0) + extra
    assert len(out) == data_at
    path.write_bytes(out + b"".join(blocks))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("tile", [None, (16, 32)])
@pytest.mark.parametrize("byteorder", ["<", ">"])
def test_floating_point_predictor(tmp_path, dtype, tile, byteorder):
    """Predictor 3 in strips and tiles, float32 and float64, either byte
    order, reads to the floats written.  The JAX package's PIL reads the
    little-endian float32 files to the same raster; it refuses float64
    files and misreads big-endian ones (so those are held against the
    floats alone)."""
    data = (np.random.default_rng(3).standard_normal((37, 53)) * 1e3).astype(dtype)
    data[5, :7] = [0.0, -0.0, np.inf, -np.inf, 1e-30, 3e38, -1.5]
    path = tmp_path / "p3.tif"
    _predictor3_tiff(path, data, tile, byteorder)
    got = tr.read_geotiff(path)
    assert got.data.dtype == dtype
    np.testing.assert_array_equal(got.data.view(f"u{data.itemsize}"),
                                  data.view(f"u{data.itemsize}"))
    if dtype == np.float32 and byteorder == "<":
        _same_raster(got, jr.read_geotiff(path))


def test_floating_point_predictor_from_libtiff(tmp_path):
    """PIL asks libtiff for predictor 3: the port reads libtiff's file as
    PIL does."""
    data = (np.random.default_rng(4).standard_normal((45, 61)) * 100).astype(np.float32)
    for compression in ("tiff_adobe_deflate", "tiff_lzw"):
        Image.fromarray(data).save(tmp_path / "lt.tif", compression=compression,
                                   tiffinfo={317: 3})
        assert tiff.read_tiff(tmp_path / "lt.tif").tags[tiff.TAG_PREDICTOR] == (3,)
        _same_raster(tr.read_geotiff(tmp_path / "lt.tif"), jr.read_geotiff(tmp_path / "lt.tif"))
        np.testing.assert_array_equal(tr.read_geotiff(tmp_path / "lt.tif").data, data)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int32, np.float32, "rgb",
                                   "rgba"])
def test_bigtiff_reads_as_the_jax_package(tmp_path, dtype):
    """BigTIFF (version 43, 8-byte offsets, 20-byte entries, LONG8 strip
    offsets) written by PIL (its own writer, uncompressed: PIL hands
    compressed files to libtiff, which writes classic TIFF) reads to the
    JAX package's raster, GeoTIFF tags included."""
    if dtype in ("rgb", "rgba"):
        data = _samples(np.uint8, (29, 41, 3 if dtype == "rgb" else 4))
    else:
        data = _samples(dtype, (64, 64))
    ifd = ImageFileDirectory_v2()
    ifd[33550] = (0.5, 0.5, 0.0)
    ifd[33922] = (0.0, 0.0, 0.0, 500000.0, 4000000.0, 0.0)
    ifd[34735] = (1, 1, 0, 2, 1024, 0, 1, 1, 3072, 0, 1, 32611)
    ifd[42113] = "255"
    Image.fromarray(data).save(tmp_path / "big.tif", big_tiff=True, tiffinfo=ifd)
    assert (tmp_path / "big.tif").read_bytes()[2:4] == b"+\x00"
    got = tr.read_geotiff(tmp_path / "big.tif")
    _same_raster(got, jr.read_geotiff(tmp_path / "big.tif"))
    assert got.epsg == 32611 and got.nodata == 255.0
    assert tr.read_geotiff_grid(tmp_path / "big.tif") == (
        data.shape[:2], got.transform, got.epsg)


def _bigtiff_long8(path, data, byteorder):
    """A BigTIFF of one uint16 band, two strips, built by hand: the size
    tags and the strips' offsets and byte counts of type LONG8 (16), a
    SubIFDs entry of type IFD8 (18) and a private tag of SLONG8 (17)
    values."""
    bo = byteorder
    h, w = data.shape
    strips = [data[:h // 2], data[h // 2:]]
    payload = [s.astype(bo + "u2").tobytes() for s in strips]
    entries = [(256, 16, [w]), (257, 16, [h]), (258, 3, [16]), (259, 3, [1]),
               (262, 3, [1]), (273, 16, None), (278, 16, [h // 2]), (279, 16,
               [len(p) for p in payload]), (330, 18, [0]), (65000, 17, [-5, 7])]
    ifd_len = 8 + 20 * len(entries) + 8
    extra_at = 16 + ifd_len
    data_at = extra_at + 3 * 16  # LONG8 offsets and counts, SLONG8 values
    code = {3: "H", 16: "Q", 17: "q", 18: "Q"}
    ifd, extra = struct.pack(bo + "Q", len(entries)), b""
    for tag, typ, vals in entries:
        if vals is None:
            vals = [data_at, data_at + len(payload[0])]
        raw = struct.pack(bo + code[typ] * len(vals), *vals)
        if len(raw) <= 8:
            ifd += struct.pack(bo + "HHQ", tag, typ, len(vals)) + raw.ljust(8, b"\x00")
        else:
            ifd += struct.pack(bo + "HHQQ", tag, typ, len(vals), extra_at + len(extra))
            extra += raw
    head = (b"II" if bo == "<" else b"MM") + struct.pack(bo + "HHHQ", 43, 8, 0, 16)
    out = head + ifd + struct.pack(bo + "Q", 0) + extra
    assert len(out) == data_at
    path.write_bytes(out + b"".join(payload))


@pytest.mark.parametrize("byteorder", ["<", ">"])
def test_bigtiff_long8_slong8_ifd8(tmp_path, byteorder):
    data = _samples(np.uint16, (22, 31))
    _bigtiff_long8(tmp_path / "b8.tif", data, byteorder)
    img = tiff.read_tiff(tmp_path / "b8.tif")
    np.testing.assert_array_equal(img.data, data)
    assert img.tags[330] == (0,) and img.tags[65000] == (-5, 7)
    if byteorder == "<":
        _same_raster(tr.read_geotiff(tmp_path / "b8.tif"), jr.read_geotiff(tmp_path / "b8.tif"))


def test_bigtiff_header_must_have_8_byte_offsets(tmp_path):
    (tmp_path / "x.tif").write_bytes(b"II+\x00\x04\x00\x00\x00" + bytes(8))
    with pytest.raises(ValueError, match="not a classic TIFF or BigTIFF"):
        tiff.read_tiff(tmp_path / "x.tif")


def test_grid_reads_the_tags_alone(tmp_path):
    """``read_geotiff_grid`` gives the shape, transform and EPSG that
    ``read_geotiff`` gives, from the directory alone."""
    r = tr.Raster(_samples(np.float32, (300, 520)), (0.25, 0.0, 10.0, 0.0, -0.25, 50.0),
                  32611, -1.0)
    tr.write_geotiff(tmp_path / "g.tif", r, compression="deflate", tile=(256, 256))
    full = tr.read_geotiff(tmp_path / "g.tif")
    assert tr.read_geotiff_grid(tmp_path / "g.tif") == ((300, 520), full.transform,
                                                        full.epsg)


def _both(data, nodata=None, epsg=32611):
    transform = (0.5, 0.0, 500000.0, 0.0, -0.5, 4000000.0)
    return jr.Raster(data, transform, epsg, nodata), tr.Raster(data, transform, epsg, nodata)


@pytest.mark.parametrize("method", ["nearest", "bilinear"])
@pytest.mark.parametrize("bands", [1, 3])
def test_sample_matches_jax(method, bands):
    rng = np.random.default_rng(3)
    data = rng.random((40, 60) if bands == 1 else (40, 60, 3)).astype(np.float32)
    data[5, 7] = -9999.0
    j, t = _both(data, nodata=-9999.0)
    xs = rng.uniform(499990.0, 500040.0, 700)
    ys = rng.uniform(3999975.0, 4000010.0, 700)
    np.testing.assert_array_equal(t.sample(xs, ys, method), j.sample(xs, ys, method))


@pytest.mark.parametrize("dst,method", [(4326, "nearest"), (4326, "bilinear"),
                                        (32610, "nearest")])
@pytest.mark.parametrize("dtype,nodata", [(np.float32, None), (np.float32, -9999.0),
                                          (np.uint8, 255.0)])
def test_reprojected_matches_jax(dst, method, dtype, nodata):
    rng = np.random.default_rng(4)
    data = (rng.random((24, 30)) * 200).astype(dtype)
    j, t = _both(data, nodata=nodata)
    a, b = j.reprojected(dst, method=method), t.reprojected(dst, method=method)
    np.testing.assert_array_equal(b.data, a.data)
    assert b.data.dtype == a.data.dtype
    assert tuple(b.transform) == tuple(a.transform) and b.epsg == a.epsg
    assert b.nodata == a.nodata


@pytest.mark.parametrize("factor", [2, 3, 5])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_downsampled_matches_jax(factor, dtype):
    """cv2's INTER_AREA against the port's ``resize_area``: float32 to
    rtol 1e-6, uint8 within +-1 (ROADMAP C4); the transform exactly."""
    rng = np.random.default_rng(5)
    data = (rng.random((61, 47)) * 250).astype(dtype)
    j, t = _both(data)
    a, b = j.downsampled(factor), t.downsampled(factor)
    assert b.data.shape == a.data.shape and b.data.dtype == a.data.dtype
    assert tuple(b.transform) == tuple(a.transform)
    if dtype == np.uint8:
        assert np.abs(b.data.astype(int) - a.data.astype(int)).max() <= 1
    else:
        np.testing.assert_allclose(b.data, a.data, rtol=1e-6, atol=0)


def test_reproject_raster_file_matches_jax(tmp_path):
    data = _samples(np.float32, (20, 26))
    j, t = _both(data, nodata=-1.0)
    jr.write_geotiff(tmp_path / "in.tif", j)
    jr.reproject_raster(tmp_path / "in.tif", tmp_path / "j.tif", 4326)
    tr.reproject_raster(tmp_path / "in.tif", tmp_path / "t.tif", 4326)
    _same_raster(tr.read_geotiff(tmp_path / "t.tif"), jr.read_geotiff(tmp_path / "j.tif"))
