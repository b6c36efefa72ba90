"""The port's TIFF codec and GeoTIFF rasters (``utils/tiff.py``,
``utils/raster.py``) against PIL and the JAX package's ``utils/raster.py``.

Files go both ways: what the JAX package (PIL) writes the port reads to
the same ``Raster`` (data bit for bit, transform, EPSG, nodata), and what
the port writes the JAX package reads the same.  Sampling, reprojection
and downsampling are held against the JAX package's: nearest and bilinear
samples and reprojected grids exactly, ``downsampled`` to float32
rounding (cv2's INTER_AREA against ``resize_area``, rtol 1e-6) and to +-1
on uint8 (ROADMAP C4)."""

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
