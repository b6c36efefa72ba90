"""The port's host-side file formats against the JAX package's and against
cv2 / imageio: the PNG codec, the run-length pix2face cache, vector files,
the PLY writer, the distance test that stands in for the raster polygon
buffer, and the synthetic survey on disk."""

import json
import struct
import sys
import zlib

import cv2
import imageio.v3 as iio
import numpy as np
import pytest
from PIL import Image

from chip_smoke import encode_png_filtered
from geograypher_tpu.utils import cache as jcache
from geograypher_tpu.utils import vector as jvector
from geograypher_tpu.utils.meshio import load_mesh as jload_mesh
from geograypher_tpu_torch.utils import cache as tcache
from geograypher_tpu_torch.utils import io as tio
from geograypher_tpu_torch.utils import vector as tvector
from geograypher_tpu_torch.utils.meshio import load_mesh, save_mesh
from tests.test_torch_rasterize import one_torch_thread  # noqa: F401


def _images():
    rng = np.random.default_rng(0)
    return {
        "gray8": rng.integers(0, 256, (37, 53), dtype=np.uint8),
        "rgb8": rng.integers(0, 256, (21, 34, 3), dtype=np.uint8),
        "rgba8": rng.integers(0, 256, (9, 11, 4), dtype=np.uint8),
        "gray16": rng.integers(0, 65536, (18, 25), dtype=np.uint16),
        "mask": np.where(rng.random((40, 64)) < 0.5, 255, 3).astype(np.uint8),
        "one_pixel": np.array([[7]], np.uint8),
    }


@pytest.mark.parametrize("name", sorted(_images()))
def test_png_round_trip_and_other_readers(name, tmp_path):
    """What the codec writes it reads back exactly, and so do cv2 and
    imageio."""
    img = _images()[name]
    path = tmp_path / f"{name}.png"
    n_bytes = tio.write_image(path, img)
    assert n_bytes == path.stat().st_size
    back = tio.decode_png(path.read_bytes())
    assert back.dtype == img.dtype
    np.testing.assert_array_equal(back, img)
    np.testing.assert_array_equal(tio.read_image_or_numpy(path), img)
    np.testing.assert_array_equal(np.asarray(iio.imread(path)), img)
    theirs = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if img.ndim == 3:  # cv2 holds colour images as BGR(A)
        theirs = theirs[..., [2, 1, 0, 3][: img.shape[2]]]
    np.testing.assert_array_equal(theirs, img)


@pytest.mark.parametrize("name", ["gray8", "rgb8", "gray16", "mask"])
@pytest.mark.parametrize("png_filter", ["none", "sub", "up", "paeth"])
def test_png_reads_what_cv2_writes(name, png_filter, tmp_path):
    """cv2's files at filter types 0, 1, 2 and 4 (Paeth) go through the
    port's own decoder."""
    img = _images()[name]
    flag = {"none": cv2.IMWRITE_PNG_FILTER_NONE, "sub": cv2.IMWRITE_PNG_FILTER_SUB,
            "up": cv2.IMWRITE_PNG_FILTER_UP, "paeth": cv2.IMWRITE_PNG_FILTER_PAETH}
    path = tmp_path / "cv.png"
    bgr = img[..., ::-1] if img.ndim == 3 else img
    assert cv2.imwrite(str(path), bgr, [cv2.IMWRITE_PNG_FILTER, flag[png_filter]])
    own = tio.decode_png(path.read_bytes())
    np.testing.assert_array_equal(own, img)
    np.testing.assert_array_equal(tio.read_image_or_numpy(path), img)


@pytest.fixture
def no_imageio(monkeypatch):
    """``import imageio.v3`` raises, as on a machine without imageio."""
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v3", None)


def _filter_images():
    rng = np.random.default_rng(5)
    images = dict(_images())
    images["gray_alpha8"] = rng.integers(0, 256, (13, 17, 2), dtype=np.uint8)
    images["rgb16"] = rng.integers(0, 65536, (12, 9, 3), dtype=np.uint16)
    images["rgba16"] = rng.integers(0, 65536, (7, 10, 4), dtype=np.uint16)
    images["gray_alpha16"] = rng.integers(0, 65536, (6, 5, 2), dtype=np.uint16)
    return images


@pytest.mark.parametrize("rows", ["average", "paeth", "mixed"])
@pytest.mark.parametrize("name", sorted(_filter_images()))
def test_png_filter_types_3_and_4_decode_as_pil(name, rows, no_imageio, tmp_path):
    """Rows of filter type 3 (Average) and 4 (Paeth), on every row or mixed
    with types 0-2 from row to row, in 8 and 16 bits, gray, gray + alpha,
    RGB and RGBA, decode to the image, as PIL reads the same file, with
    imageio refused."""
    img = _filter_images()[name]
    h = img.shape[0]
    filters = {"average": np.full(h, 3), "paeth": np.full(h, 4),
               "mixed": np.random.default_rng(h).integers(0, 5, h)}[rows]
    path = tmp_path / "f.png"
    path.write_bytes(encode_png_filtered(img, filters))
    np.testing.assert_array_equal(tio.read_image_or_numpy(path), img)
    got = tio.decode_png(path.read_bytes())
    assert got.dtype == img.dtype
    with Image.open(path) as pil:
        pil_img = np.asarray(pil)
    if img.dtype == np.uint8 or img.ndim == 2:  # PIL holds 16-bit colour as 8 bits
        np.testing.assert_array_equal(got, pil_img)


def _row_filters(data: bytes, row_bytes: int) -> set:
    """The filter types of a PNG file's rows."""
    pos, idat = 8, b""
    while pos < len(data):
        length, kind = struct.unpack_from(">I4s", data, pos)
        if kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + length]
        pos += 12 + length
    raw = zlib.decompress(idat)
    return set(raw[::1 + row_bytes])


@pytest.mark.parametrize("shape", [(540, 384), (96, 77, 3), (40, 33, 4), (1, 300),
                                   (300, 1)])
def test_png_pil_and_jax_files_decode_without_imageio(shape, monkeypatch, tmp_path):
    """PIL picks a filter type for every row (Paeth among them on smooth
    images); the port reads its files, and the JAX package's
    ``write_image`` files (imageio over Pillow), as PIL does, with
    imageio refused."""
    from geograypher_tpu.utils.io import write_image as jax_write_image

    rng = np.random.default_rng(1)
    i, j = np.mgrid[:shape[0], :shape[1]]
    wave = 128 + 100 * np.sin(i / 9) * np.cos(j / 7)
    img = wave.reshape(shape[:2] + (1,) * (len(shape) - 2)) + rng.integers(0, 3, shape)
    img = img.astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "pil.png")
    jax_write_image(tmp_path / "jax.png", img)
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v3", None)
    for name in ("pil.png", "jax.png"):
        with Image.open(tmp_path / name) as pil:
            want = np.asarray(pil)
        np.testing.assert_array_equal(want, img)
        np.testing.assert_array_equal(tio.read_image_or_numpy(tmp_path / name), want)
    if shape[0] > 1 and shape[1] > 1:
        filters = _row_filters((tmp_path / "pil.png").read_bytes(),
                               int(np.prod(shape[1:])))
        assert 4 in filters, filters


def test_png_reads_what_imageio_writes(tmp_path):
    for name, img in _images().items():
        path = tmp_path / f"{name}.png"
        iio.imwrite(path, img)
        np.testing.assert_array_equal(tio.read_image_or_numpy(path), img)


def test_png_refusals(tmp_path):
    with pytest.raises(ValueError, match="float64"):
        tio.encode_png(np.zeros((4, 4)))
    with pytest.raises(ValueError, match="not a PNG"):
        tio.decode_png(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError, match="only .png and .npy"):
        tio.write_image(tmp_path / "a.jpg", np.zeros((2, 2), np.uint8))
    # a palette image is not the decoder's: None, and imageio reads it
    from PIL import Image

    pal = Image.fromarray(np.arange(12, dtype=np.uint8).reshape(3, 4) % 3, "P")
    pal.putpalette([0, 0, 0, 255, 0, 0, 0, 255, 0])
    pal.save(tmp_path / "pal.png")
    assert tio.decode_png((tmp_path / "pal.png").read_bytes()) is None
    assert tio.read_image_or_numpy(tmp_path / "pal.png").shape[:2] == (3, 4)
    arr = np.arange(6.0).reshape(2, 3)
    tio.write_image(tmp_path / "a.npy", arr)
    np.testing.assert_array_equal(tio.read_image_or_numpy(tmp_path / "a.npy"), arr)


def test_zlib_level_changes_size_not_content():
    img = _images()["mask"]
    small, large = tio.encode_png(img, 9), tio.encode_png(img, 0)
    assert len(small) < len(large)
    np.testing.assert_array_equal(tio.decode_png(small), tio.decode_png(large))
    assert zlib.crc32(small[12:29]) == int.from_bytes(small[29:33], "big")  # IHDR


@pytest.mark.parametrize("src,dst", [((48, 64), (96, 128)), ((48, 64), (97, 131)),
                                     ((54, 96), (108, 192)), ((50, 70), (20, 33)),
                                     ((1080, 1920), (2160, 3840)), ((7, 5), (7, 5))])
def test_resize_nearest_equals_cv2(src, dst):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, src).astype(np.float32)
    want = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(tio.resize_nearest(img, dst[1], dst[0]), want)


def _p2f_maps():
    rng = np.random.default_rng(2)
    runs = np.repeat(rng.integers(-1, 5000, 300), rng.integers(1, 40, 300))
    return {
        "runs": runs[: 60 * 90].reshape(60, 90).astype(np.int32),
        "noise": rng.integers(-1, 2**31 - 1, (13, 17)).astype(np.int32),
        "constant": np.full((3, 8, 9), -1, np.int32),
        "single": np.array([[5]], np.int32),
    }


@pytest.mark.parametrize("name", sorted(_p2f_maps()))
def test_cache_files_are_shared_with_the_jax_package(name, tmp_path):
    """Either package reads the other's cache entry, and the files are
    equal byte for byte."""
    arr = _p2f_maps()[name]
    key = ["mesh", "cam", 0.5, True, "cfg"]
    ours = tcache.save_pix2face(arr, "pix2face", key, tmp_path / "t")
    theirs = jcache.save_pix2face(arr, "pix2face", key, tmp_path / "j")
    assert ours.name == theirs.name
    assert ours.read_bytes() == theirs.read_bytes()
    for load, folder in ((tcache.load_pix2face, "j"), (jcache.load_pix2face, "t")):
        back = load("pix2face", key, tmp_path / folder)
        assert back.dtype == np.int32
        np.testing.assert_array_equal(back, arr)
    assert tcache.load_pix2face("pix2face", key + ["other"], tmp_path / "t") is None


def test_cache_clears_corrupt_entries(tmp_path):
    arr = _p2f_maps()["runs"]
    path = tcache.save_pix2face(arr, "pix2face", ["k"], tmp_path)
    path.write_bytes(path.read_bytes()[:-8])  # a run is missing
    assert tcache.load_pix2face("pix2face", ["k"], tmp_path) is None
    assert not path.exists()
    path.write_bytes(b"notmagic" + bytes(32))
    assert tcache.load_pix2face("pix2face", ["k"], tmp_path) is None
    assert not path.exists()
    # the .npz entry the JAX package writes without its native codec
    np.savez_compressed(path.with_suffix(".npz"), pix2face=arr)
    np.testing.assert_array_equal(
        tcache.load_pix2face("pix2face", ["k"], tmp_path), arr)


def _vector_data(mod, epsg=32611, square=False):
    """Five seeded star polygons (two with a hole) in UTM; ``square`` adds
    two corner triangles that make the bounds a square."""
    rng = np.random.default_rng(3)
    polys, names = [], []
    if square:
        for corner, sign in ((-20.0, 1.0), (120.0, -1.0)):
            c = np.array([corner, corner]) + (3.2e5, 4.1e6)
            polys.append(mod.Polygon(c + sign * np.array([[0, 0], [1, 0], [0, 1.0]])))
            names.append("corner")
    for k in range(5):
        c = rng.uniform(0, 100, 2) + (3.2e5, 4.1e6)
        ang = np.sort(rng.uniform(0, 2 * np.pi, 7))
        ring = c + rng.uniform(5, 15, (7, 1)) * np.stack([np.cos(ang), np.sin(ang)], 1)
        holes = [c + 1.5 * np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]])] if k % 2 else []
        polys.append(mod.Polygon(ring, holes))
        names.append(f"sp_{k % 3}")
    return mod.VectorData(
        polys, {"species": names, "height": list(range(len(polys)))}, epsg)


def _same_vector(a, b):
    assert a.epsg == b.epsg and len(a) == len(b)
    assert {k: [str(x) for x in v] for k, v in a.attributes.items()} == \
        {k: [str(x) for x in v] for k, v in b.attributes.items()}
    for ga, gb in zip(a.geometries, b.geometries):
        if isinstance(ga, np.ndarray):
            np.testing.assert_array_equal(ga, gb)
            continue
        # rings written closed read back with the repeated first point
        for ra, rb in zip([ga.exterior] + ga.holes, [gb.exterior] + gb.holes):
            np.testing.assert_array_equal(ra, rb)


@pytest.mark.parametrize("suffix", [".geojson", ".gpkg"])
def test_vector_files_match_jax(suffix, tmp_path):
    """Files written by either package read back equal through both."""
    ours, theirs = _vector_data(tvector), _vector_data(jvector)
    ours.to_file(tmp_path / f"t{suffix}")
    theirs.to_file(tmp_path / f"j{suffix}")
    if suffix == ".geojson":
        assert json.loads((tmp_path / "t.geojson").read_text()) == \
            json.loads((tmp_path / "j.geojson").read_text())
    for name in ("t", "j"):
        path = tmp_path / f"{name}{suffix}"
        _same_vector(tvector.VectorData.read_file(path),
                     jvector.VectorData.read_file(path))
    back = tvector.VectorData.read_file(tmp_path / f"j{suffix}")
    assert back.epsg == 32611 and len(back) == 5
    pts = np.random.default_rng(4).uniform(-20, 120, (500, 2)) + (3.2e5, 4.1e6)
    np.testing.assert_array_equal(back.contains_points(pts),
                                  theirs.contains_points(pts))
    assert (back.contains_points(pts) >= 0).any()
    with pytest.raises(ValueError, match="Unsupported vector format"):
        tvector.VectorData.read_file(tmp_path / "a.kml")


def test_vector_shapefile_and_projection_match_jax(tmp_path):
    """A shapefile (polygon with a hole, written by hand with its .dbf
    and .prj) and geographic data projected to UTM."""
    import struct

    ext = np.array([[0, 0], [0, 10], [10, 10], [10, 0], [0, 0]], float) + (5e5, 4e6)
    hole = np.array([[4, 4], [6, 4], [6, 6], [4, 6], [4, 4]], float) + (5e5, 4e6)
    pts = np.concatenate([ext, hole])
    content = struct.pack("<i4d2i2i", 5, *ext.min(0), *ext.max(0), 2, len(pts), 0, 5)
    content += pts.astype("<f8").tobytes()
    shp = struct.pack(">i5i", 9994, 0, 0, 0, 0, 0) + struct.pack(">i", 0)
    shp += struct.pack("<2i", 1000, 5) + bytes(64)
    shp += struct.pack(">2i", 1, len(content) // 2) + content
    (tmp_path / "a.shp").write_bytes(shp)
    (tmp_path / "a.prj").write_text('PROJCS["WGS 84 / UTM zone 11N",AUTHORITY["EPSG","32611"]]')
    dbf = struct.pack("<B3BIHH20x", 3, 24, 1, 1, 1, 32 + 32 + 1, 1 + 8)
    dbf += b"species".ljust(11, b"\x00") + b"C" + bytes(4) + bytes([8, 0]) + bytes(14)
    dbf += b"\r" + b" " + b"oak".ljust(8)
    (tmp_path / "a.dbf").write_bytes(dbf)
    ours = tvector.VectorData.read_file(tmp_path / "a.shp")
    _same_vector(ours, jvector.VectorData.read_file(tmp_path / "a.shp"))
    assert ours.epsg == 32611 and ours["species"] == ["oak"]
    assert len(ours.geometries[0].holes) == 1
    inside = ours.contains_points(np.array([[2, 2], [5, 5], [20, 20]], float) + (5e5, 4e6))
    np.testing.assert_array_equal(inside, [0, -1, -1])

    lonlat = [tvector.Polygon([[-119.0, 36.0], [-119.0, 36.001], [-118.999, 36.001]])]
    a = tvector.VectorData(lonlat, epsg=4326).ensure_projected()
    b = jvector.VectorData([jvector.Polygon(lonlat[0].exterior)], epsg=4326).ensure_projected()
    assert a.epsg == b.epsg == 32611
    np.testing.assert_array_equal(a.geometries[0].exterior, b.geometries[0].exterior)
    assert a.geometries[0].area == pytest.approx(b.geometries[0].area)
    assert a.total_bounds() == b.total_bounds()


@pytest.mark.parametrize("square", [True, False])
@pytest.mark.parametrize("dist", [3.0, 12.0, -2.0, 0.0])
def test_points_near_polygons_against_the_raster_buffer(dist, square):
    """The exact distance test against the JAX package's raster buffer
    (polygons burnt into a 2048 x 2048 grid over their padded bounds,
    dilated by ``dist`` in cells of the longer side, contours traced
    back).  Where the bounds are square the two agree on every point whose
    distance to the polygons differs from ``dist`` by more than 2 cells.
    Where they are not, the grid's cells are shorter along the shorter
    side and the raster buffer reaches only ``dist * short / long`` that
    way: points between that and ``dist`` are exempt too."""
    ours = _vector_data(tvector, square=square)
    theirs = _vector_data(jvector, square=square)
    rng = np.random.default_rng(5)
    pts = rng.uniform(-40, 140, (4000, 2)) + (3.2e5, 4.1e6)
    got = tvector.points_near_polygons(ours.geometries, pts, dist)
    cell, short_of = 0.0, 1.0
    buffered = theirs.geometries
    if dist:
        buffered = jvector.buffer_polygons(theirs.geometries, dist)
        bs = np.asarray([p.bounds for p in theirs.geometries])
        pad = abs(dist) * 1.5 + 1e-9
        sides = (bs[:, 2].max() - bs[:, 0].min() + 2 * pad,
                 bs[:, 3].max() - bs[:, 1].min() + 2 * pad)
        cell, short_of = max(sides) / 2048, min(sides) / max(sides)
        assert (short_of == 1.0) == square
    want = np.zeros(len(pts), bool)
    for p in buffered:
        want |= p.contains_points(pts)
    # signed distance to the polygons' union: negative inside
    inside = tvector.points_near_polygons(ours.geometries, pts, 0.0)
    edges = [tvector._ring_edges(r) for g in ours.geometries
             for r in [g.exterior] + g.holes]
    d_edge = tvector._distance_to_edges(pts, np.concatenate([e[0] for e in edges]),
                                        np.concatenate([e[1] for e in edges]))
    signed = np.where(inside, -d_edge, d_edge)
    lo, hi = sorted((dist * short_of, dist))
    clear = (signed < lo - 2 * cell) | (signed > hi + 2 * cell)
    assert clear.mean() > 0.9 and 0.005 < got.mean() < 0.98
    np.testing.assert_array_equal(got[clear], want[clear])
    # chunked evaluation changes nothing
    np.testing.assert_array_equal(
        tvector.points_near_polygons(ours.geometries, pts, dist, chunk=97), got)


def test_save_mesh_matches_jax(tmp_path):
    from geograypher_tpu.utils.meshio import save_mesh as jsave_mesh

    rng = np.random.default_rng(6)
    verts = rng.normal(size=(40, 3)) * 1e6
    faces = rng.integers(0, 40, (70, 3)).astype(np.int32)
    colors = rng.integers(0, 256, (40, 3)).astype(np.uint8)
    for kw in ({}, {"vert_colors": colors}, {"binary": False}):
        save_mesh(tmp_path / "t.ply", verts, faces, **kw)
        jsave_mesh(tmp_path / "j.ply", verts, faces, **kw)
        assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
        for loader in (load_mesh, jload_mesh):
            v, f, attrs = loader(tmp_path / "t.ply")
            np.testing.assert_array_equal(f, faces)
            if kw.get("binary", True):
                np.testing.assert_array_equal(v, verts)
            if "vert_colors" in kw:
                np.testing.assert_array_equal(attrs["colors"], colors)
    save_mesh(tmp_path / "t.npz", verts, faces)
    np.testing.assert_array_equal(load_mesh(tmp_path / "t.npz")[0], verts)
    with pytest.raises(ValueError, match="Unsupported save format"):
        save_mesh(tmp_path / "t.stl", verts, faces)


def test_example_survey_matches_jax(tmp_path):
    """The survey on disk: the same mesh, camera XML, polygons, label
    images (pixel for pixel) and DTM GeoTIFF (the same raster, through
    either package's reader) as the JAX package's generator."""
    from geograypher_tpu.utils import example_data as jex
    from geograypher_tpu_torch.utils import example_data as tex

    np.testing.assert_array_equal(tex.local_to_ecef_frame(36.0, -119.0, 12.0),
                                  jex.local_to_ecef_frame(36.0, -119.0, 12.0))
    ours = tex.create_example_survey(tmp_path / "t", device="cpu")
    theirs = jex.create_example_survey(tmp_path / "j")
    assert set(ours) == set(theirs)
    from geograypher_tpu.utils.raster import read_geotiff as jax_read_geotiff
    from geograypher_tpu_torch.utils.raster import read_geotiff

    for path in (ours["dtm_file"], theirs["dtm_file"]):
        got, want = read_geotiff(path), jax_read_geotiff(theirs["dtm_file"])
        np.testing.assert_array_equal(got.data, want.data)
        assert tuple(got.transform) == tuple(want.transform) and got.epsg == want.epsg
    assert ours["cameras_file"].read_text() == theirs["cameras_file"].read_text()
    assert ours["mesh_file"].read_bytes() == theirs["mesh_file"].read_bytes()
    assert json.loads(ours["labels_vector_file"].read_text()) == \
        json.loads(theirs["labels_vector_file"].read_text())
    np.testing.assert_array_equal(ours["face_labels"], theirs["face_labels"])
    for k in range(4):
        name = f"img_{k:04d}.png"
        for folder in ("label_folder", "image_folder"):
            mine = tio.read_image_or_numpy(ours[folder] / name)
            np.testing.assert_array_equal(
                mine, np.asarray(iio.imread(theirs[folder] / name)))
        assert set(np.unique(mine)) == {127}
    labels = tio.read_image_or_numpy(ours["label_folder"] / "img_0000.png")
    assert labels.shape == (96, 96) and len(np.unique(labels)) >= 3
    xml = tex.make_metashape_xml([np.eye(4)], ["a.png"], np.eye(4), 10.0, 8, 6,
                                 cx=0.5, distortion={"k1": 0.1})
    assert xml == jex.make_metashape_xml([np.eye(4)], ["a.png"], np.eye(4), 10.0,
                                         8, 6, cx=0.5, distortion={"k1": 0.1})


@pytest.mark.parametrize("src,dst", [((96, 128), (48, 64)), ((96, 128), (35, 47)),
                                     ((90, 120), (30, 40)), ((64, 64), (64, 21)),
                                     ((50, 70), (49, 69))])
def test_resize_area_matches_cv2(src, dst, tmp_path):
    """Area-averaging downscale against cv2's INTER_AREA: float images to
    1e-4 of their range, uint8 images to +-1 (cv2 rounds its own float
    sums)."""
    rng = np.random.default_rng(7)
    for img in (rng.random(src).astype(np.float32),
                rng.random(src + (3,)).astype(np.float32) * 255):
        want = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_AREA)
        got = tio.resize_area(img, dst[1], dst[0])
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, atol=1e-4 * max(img.max(), 1.0), rtol=0)
    u8 = rng.integers(0, 256, src + (3,), dtype=np.uint8)
    want = cv2.resize(u8, (dst[1], dst[0]), interpolation=cv2.INTER_AREA)
    got = tio.resize_area(u8, dst[1], dst[0])
    assert got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    # one axis up takes cv2's linear variant of INTER_AREA on both axes
    up = cv2.resize(u8, (src[1] + 1, src[0]), interpolation=cv2.INTER_AREA)
    assert np.abs(tio.resize_area(u8, src[1] + 1, src[0]).astype(int)
                  - up.astype(int)).max() <= 1
    # CameraSet.get_image_by_index scales a stored image with it
    from geograypher_tpu_torch.cameras.core import CameraSet

    tio.write_image(tmp_path / "a.png", u8)
    cams = CameraSet([np.eye(4)], image_filenames=[tmp_path / "a.png"])
    np.testing.assert_array_equal(cams.get_image_by_index(0), u8)
    half = cams.get_image_by_index(0, 0.5)
    assert half.shape == (src[0] // 2, src[1] // 2, 3)
    np.testing.assert_array_equal(half, tio.resize_area(u8, src[1] // 2, src[0] // 2))
