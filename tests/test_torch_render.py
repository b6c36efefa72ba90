"""The render path of the PyTorch port against the JAX package on the CPU
(JAX on its XLA raster): the distortion maps and remaps, ``pix2face`` with
its cache, ``render_flat``, ``save_renders``, soft images of a distorted
sensor through ``project_images``, and the slice as a whole, the
``render_labels`` entry point and the render -> aggregate round trip."""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geograypher_tpu.cameras import distortion as jd
from geograypher_tpu.cameras.core import CameraSet as JaxCameraSet
from geograypher_tpu.cameras.metashape import MetashapeCameraSet as JaxMetashape
from geograypher_tpu.cameras.segmentor_set import (
    SegmentorCameraSet as JaxSegmentorCameraSet,
)
from geograypher_tpu.meshes.mesh import TexturedMesh as JaxTexturedMesh
from geograypher_tpu.ops.rasterize import RasterConfig as JaxRasterConfig
from geograypher_tpu.utils.fixtures import make_grid_mesh, nadir_camera, oblique_camera
from geograypher_tpu_torch import interop
from geograypher_tpu_torch.cameras import distortion as td
from geograypher_tpu_torch.entrypoints.aggregate_images import aggregate_images
from geograypher_tpu_torch.entrypoints.render_labels import render_labels
from geograypher_tpu_torch.ops.rasterize import RasterConfig
from geograypher_tpu_torch.utils.example_data import create_example_survey
from geograypher_tpu_torch.utils.io import read_image_or_numpy
from tests.test_torch_rasterize import knife_edge, one_torch_thread  # noqa: F401

W, H = 128, 96
# caps that also hold the half-resolution views, whose tiles see 4x the faces
XLA = JaxRasterConfig(caps=(640, 160, 64, 32), backend="xla")
# f, cx, cy, width, height, Brown-Conrady vector of the distorted sensor
SENSOR = (60.0, 0.5, -0.5, W, H,
          np.array([0.02, -0.01, 0.0, 0.0, 1e-3, 0.0, 0.0, 0.0]))
STRONG = (70.0, -1.5, 2.0, W, H,
          np.array([0.08, -0.03, 0.01, 0.0, 2e-3, -1e-3, 0.4, -0.2]))
MAP_ATOL = 1e-3  # px: XLA contracts the polynomials into FMAs, torch does not


def jax_maps(sensor, scale=1.0):
    f, cx, cy, w, h, dist = sensor
    return [np.asarray(m) for m in jd.make_maps(
        jnp.float32(f), jnp.float32(cx), jnp.float32(cy), w, h,
        jnp.asarray(dist, jnp.float32), scale)]


def port_maps(sensor, scale=1.0):
    f, cx, cy, w, h, dist = sensor
    return td.make_maps(f, cx, cy, w, h, dist, scale, device="cpu")


def near_half(ijmap, tol=MAP_ATOL):
    """Pixels where a map value lies within ``tol`` of k + 0.5, so that a
    map ``tol`` away may round to the neighbouring source pixel."""
    frac = ijmap - np.floor(ijmap)
    return (np.abs(frac - 0.5) <= tol).any(axis=0)


@pytest.mark.parametrize("scale", [1.0, 0.5, 0.37])
@pytest.mark.parametrize("sensor", [SENSOR, STRONG], ids=["mild", "strong"])
def test_maps_match_jax(sensor, scale):
    for ours, theirs in zip(port_maps(sensor, scale), jax_maps(sensor, scale)):
        assert ours.shape == theirs.shape == (2, int(H * scale), int(W * scale))
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(ours.numpy(), theirs, atol=MAP_ATOL, rtol=0)
    # the two maps invert each other at interior pixels
    i2w, w2i = (m.numpy() for m in port_maps(sensor))
    rows, cols = np.mgrid[20:H - 20, 20:W - 20]
    back = td.remap_image(np.stack([w2i[0], w2i[1]], -1), i2w[:, 20:H - 20, 20:W - 20])
    np.testing.assert_allclose(back[..., 0], rows, atol=0.02)
    np.testing.assert_allclose(back[..., 1], cols, atol=0.02)


def test_pixel_functions_match_jax():
    f, cx, cy, w, h, dist = STRONG
    rng = np.random.default_rng(0)
    x = rng.uniform(0, w, 500).astype(np.float32)
    y = rng.uniform(0, h, 500).astype(np.float32)
    t = lambda v: torch.as_tensor(v, dtype=torch.float32)  # noqa: E731
    j = lambda v: jnp.asarray(v, jnp.float32)  # noqa: E731
    for ours, theirs in ((td.ideal_to_warped_pixels, jd.ideal_to_warped_pixels),
                         (td.warped_to_ideal_pixels, jd.warped_to_ideal_pixels)):
        got = ours(t(x), t(y), t(f), t(cx), t(cy), w, h, t(dist))
        want = theirs(j(x), j(y), j(f), j(cx), j(cy), w, h, j(dist))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=MAP_ATOL, rtol=0)
    wx, wy = td.ideal_to_warped_pixels(t(x), t(y), t(f), t(cx), t(cy), w, h, t(dist))
    ix, iy = td.warped_to_ideal_pixels(wx, wy, t(f), t(cx), t(cy), w, h, t(dist))
    np.testing.assert_allclose(ix.numpy(), x, atol=0.01)
    np.testing.assert_allclose(iy.numpy(), y, atol=0.01)


@pytest.mark.parametrize("kind", ["pix2face", "channels", "halves"])
def test_remap_image_torch_is_exact_on_the_same_map(kind):
    """Same map in, same image out as ``remap_image_jax``, bit for bit;
    with each package's own map, equal except where the JAX map lies
    within 1e-3 px of a half-integer."""
    rng = np.random.default_rng(1)
    shift = np.array([6.0, -8.0], np.float32).reshape(2, 1, 1)  # some sources outside
    w2i = jax_maps(STRONG)[1] + shift
    if kind == "halves":  # exact halves round to even in both
        w2i = np.round(w2i * 2) / 2
    if kind == "channels":
        img, fill = rng.random((H, W, 3)).astype(np.float32), 0.25
    else:
        img, fill = rng.integers(-1, 2**26, (H, W)).astype(np.int32), -1
    want = np.asarray(jd.remap_image_jax(jnp.asarray(img), jnp.asarray(w2i),
                                         fill_value=fill))
    got = td.remap_image_torch(torch.as_tensor(img), torch.as_tensor(w2i.copy()), fill)
    assert got.dtype == torch.as_tensor(img).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == fill).any() and (want != fill).any()
    if kind == "pix2face":
        own = td.remap_image_torch(torch.as_tensor(img),
                                   port_maps(STRONG)[1] + torch.as_tensor(shift), fill)
        differ = own.numpy() != want
        assert not (differ & ~near_half(w2i)).any()
        # the host gather on the same map: the same image
        np.testing.assert_array_equal(
            td.remap_image(img, w2i, fill_value=fill, interpolation_order=0), want)


def test_host_remap_matches_jax_package():
    rng = np.random.default_rng(2)
    i2w, w2i = jax_maps(SENSOR)
    ids = rng.integers(-1, 2**26, (H, W)).astype(np.int32)
    np.testing.assert_array_equal(td.remap_image(ids, w2i, -1, 0),
                                  jd.remap_image(ids, w2i, -1, 0))
    # float nearest neighbour: cv2 rounds map values as the gather does,
    # except at exact halves, which this map does not hold
    img = rng.random((H, W)).astype(np.float32)
    assert not near_half(w2i, 1e-6).any()
    np.testing.assert_array_equal(td.remap_image(img, w2i, 0.5, 0),
                                  jd.remap_image(img, w2i, 0.5, 0))
    # bilinear: cv2 quantises the fractional position to 1/32 px, the port
    # interpolates in plain float32: on a smooth image the two differ by
    # less than the largest neighbour difference / 16
    rows, cols = np.mgrid[0:H, 0:W].astype(np.float32)
    for smooth in (np.sin(rows / 9) + np.cos(cols / 7),
                   np.stack([rows + cols, rows * cols / 50], -1)):
        smooth = smooth.astype(np.float32)
        step = max(np.abs(np.diff(smooth, axis=0)).max(),
                   np.abs(np.diff(smooth, axis=1)).max())
        inner = (slice(4, H - 4), slice(4, W - 4))
        for ijmap in (i2w, w2i):
            got = td.remap_image(smooth, ijmap, 0.0, 1)
            want = jd.remap_image(smooth, ijmap, 0.0, 1)
            assert got.shape == want.shape and got.dtype == want.dtype
            np.testing.assert_allclose(got[inner], want[inner], atol=step / 16, rtol=0)
    u8 = (smooth[..., 0] % 256).astype(np.uint8)
    got, want = td.remap_image(u8, w2i, 0, 1), jd.remap_image(u8, w2i, 0, 1)
    assert got.dtype == np.uint8
    assert np.abs(got[inner].astype(int) - want[inner].astype(int)).max() <= 1 + 255 // 16


def test_distortion_engine_matches_jax():
    f, cx, cy, w, h, dist = SENSOR
    engine, jengine = td.DistortionEngine(device="cpu"), jd.DistortionEngine()
    assert engine.key(dist, f, cx, cy, w, h, 0.5) == jengine.key(dist, f, cx, cy, w, h, 0.5)
    maps = engine.get_maps(f, cx, cy, w, h, dist)
    assert engine.get_maps(f, cx, cy, w, h, dist)[0] is maps[0]  # kept
    for ours, theirs in zip(maps, jengine.get_maps(f, cx, cy, w, h, dist)):
        np.testing.assert_allclose(ours.numpy(), theirs, atol=MAP_ATOL, rtol=0)
    pix = np.random.default_rng(3).integers(0, H, (50, 2))
    for flag in (True, False):
        np.testing.assert_allclose(
            engine.warp_dewarp_pixels(pix, f, cx, cy, w, h, dist, flag),
            jengine.warp_dewarp_pixels(pix, f, cx, cy, w, h, dist, flag),
            atol=MAP_ATOL, rtol=0)
    ids = np.random.default_rng(4).integers(0, 99, (H, W)).astype(np.int32)
    got = engine.warp_dewarp_image(ids, f, cx, cy, w, h, dist, False, -1, 0)
    want = jengine.warp_dewarp_image(ids, f, cx, cy, w, h, dist, False, -1, 0)
    assert not ((got != want) & ~near_half(jax_maps(SENSOR)[1])).any()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            td.DistortionEngine()
        with pytest.raises(RuntimeError, match="CUDA"):
            td.make_maps(f, cx, cy, w, h, dist)


# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scene():
    """Grid mesh (1,568 faces, sorted) with seeded face labels (some
    unlabelled) and 4 named views, the last through the Brown-Conrady
    sensor."""
    verts, faces = make_grid_mesh(
        n=29, size=4.0, z_fn=lambda x, y: 0.15 * np.sin(3 * x) * np.cos(2 * y)
    )
    jmesh = JaxTexturedMesh((verts, faces))
    jmesh.spatial_sort_faces()
    rng = np.random.default_rng(5)
    labels = rng.integers(0, 6, jmesh.n_faces).astype(float)
    labels[rng.random(jmesh.n_faces) < 0.15] = np.nan
    jmesh.set_texture(labels, is_vertex=False)
    c2ws = [
        nadir_camera(4.0, 60.0, W),
        oblique_camera(4.0, 70.0, W, pitch_deg=25.0, azimuth_deg=30.0),
        nadir_camera(4.0, 70.0, W),
        oblique_camera(4.0, 60.0, W, pitch_deg=30.0, azimuth_deg=200.0),
    ]
    c2ws[0][:3, 3] += (0.0123, -0.0217, 0.031)  # off the pixel grid
    c2ws[2][:3, 3] += (0.3061, -0.1987, 0.0)
    f, cx, cy, w, h, dist = SENSOR
    sensors = {
        0: {"f": 60.0, "cx": 0.0, "cy": 0.0, "image_width": W, "image_height": H},
        1: {"f": 70.0, "cx": 0.0, "cy": 0.0, "image_width": W, "image_height": H},
        2: {"f": f, "cx": cx, "cy": cy, "image_width": W, "image_height": H,
            "distortion_params": {"k1": dist[0], "k2": dist[1], "p1": dist[4]}},
    }
    jcams = JaxCameraSet(c2ws, sensors, sensor_IDs=[0, 1, 1, 2],
                         image_filenames=[f"view_{k}.JPG" for k in range(4)])
    mesh = interop.mesh_from_jax(jmesh, device="cpu")
    mesh.raster_config = interop.raster_config_from_jax(XLA)
    return jmesh, jcams, mesh, interop.cameras_from_jax(jcams)


def distorted_agree(ours, theirs, jmap):
    """A distorted view's maps: equal where the JAX sampling map is clear
    of a half-integer, and by the raster contract overall."""
    knife_edge(ours, theirs)
    differ = ours != theirs
    assert (differ & ~near_half(jmap)).mean() < 0.01


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_pix2face_matches_jax(scene, scale):
    jmesh, jcams, mesh, cams = scene
    want = jmesh.pix2face(jcams, render_img_scale=scale, config=XLA)
    got = mesh.pix2face(cams, render_img_scale=scale)
    assert got.shape == want.shape == (4, int(H * scale), int(W * scale))
    assert got.dtype == np.int32
    for k in range(4):
        knife_edge(got[k], want[k])
        assert (got[k] >= 0).mean() > 0.3
    # distortion forced off and on
    plain = mesh.pix2face(cams, [3], scale, apply_distortion=False)
    knife_edge(plain[0], jmesh.pix2face(jcams, [3], scale, apply_distortion=False,
                                        config=XLA)[0])
    assert (plain[0] != got[3]).mean() > 0.02  # the remap moves pixels
    forced = mesh.pix2face(cams, [0], scale, apply_distortion=True)
    np.testing.assert_array_equal(forced[0], got[0])  # an undistorted sensor
    jmap = jax_maps(SENSOR, scale)[1]
    distorted_agree(got[3], want[3], jmap)
    on_device = mesh._pix2face_device(cams, 3, scale)
    assert on_device.dtype == torch.int32
    np.testing.assert_array_equal(on_device.numpy(), got[3])


def test_pix2face_cache(scene, tmp_path):
    """A second call reads the cache; either package reads the other's
    entries (same key: mesh hash, camera hash, scale, distortion flag,
    config)."""
    jmesh, jcams, mesh, cams = scene
    first = mesh.pix2face(cams, [0, 3], save_to_cache=True, cache_folder=tmp_path)
    files = sorted(tmp_path.glob("pix2face_*.ggr"))
    assert len(files) == 2
    stamps = [f.stat().st_mtime_ns for f in files]
    mesh._tri_cache.clear()
    again = mesh.pix2face(cams, [0, 3], save_to_cache=True, cache_folder=tmp_path)
    np.testing.assert_array_equal(again, first)
    assert not mesh._tri_cache  # nothing was rendered
    assert [f.stat().st_mtime_ns for f in files] == stamps
    np.testing.assert_array_equal(
        mesh._pix2face_device(cams, 3, save_to_cache=True, cache_folder=tmp_path).numpy(),
        first[1])
    # other scale, other config: other entries
    mesh.pix2face(cams, [0], 0.5, save_to_cache=True, cache_folder=tmp_path)
    mesh.pix2face(cams, [0], config=RasterConfig(caps=(300, 96, 48, 32)),
                  save_to_cache=True, cache_folder=tmp_path)
    assert len(list(tmp_path.glob("pix2face_*.ggr"))) == 4
    # the JAX package's entry, written under the JAX config's key, is
    # found by the port when it is given that key's parts
    from geograypher_tpu.utils import cache as jcache
    from geograypher_tpu_torch.utils import cache as tcache

    key = [jmesh.get_mesh_hash(), jcams.get_subset_cameras([0]).get_camera_hash(),
           1.0, False, repr(XLA)]
    jmesh.pix2face(jcams, [0], config=XLA, save_to_cache=True,
                   cache_folder=tmp_path / "j")
    assert mesh.get_mesh_hash() == key[0]
    assert cams.get_subset_cameras([0]).get_camera_hash() == key[1]
    knife_edge(tcache.load_pix2face("pix2face", key, tmp_path / "j"), first[0])
    ours_key = key[:4] + [repr(mesh.raster_config)]
    np.testing.assert_array_equal(
        jcache.load_pix2face("pix2face", ours_key, tmp_path), first[0])


def test_render_flat_matches_jax(scene):
    jmesh, jcams, mesh, cams = scene
    want_p2f = jmesh.pix2face(jcams, config=XLA)
    got_p2f = mesh.pix2face(cams)
    renders = list(mesh.render_flat(cams, return_camera=True))
    for k, ((img, cam), ref) in enumerate(zip(renders, jmesh.render_flat(jcams, config=XLA))):
        assert img.shape == ref.shape == (H, W, 1) and img.dtype == ref.dtype
        assert cam.image_filenames == [cams.image_filenames[k]]
        same = got_p2f[k] == want_p2f[k]
        np.testing.assert_array_equal(img[same], ref[same])
        assert np.isnan(img).any() and np.isfinite(img).any()
        # the image is the face texture looked up through pix2face
        tex = np.append(mesh.face_texture[:, 0], np.nan).astype(np.float32)
        np.testing.assert_array_equal(img[..., 0], tex[got_p2f[k]])
    # a vertex texture of three channels renders through the vote / mean
    rgb = np.random.default_rng(6).random((mesh.n_verts, 3))
    mesh_rgb = interop.mesh_from_jax(jmesh, device="cpu")
    mesh_rgb.raster_config = mesh.raster_config
    jmesh_rgb = JaxTexturedMesh(jmesh)
    for m in (mesh_rgb, jmesh_rgb):
        m.set_texture(rgb)
    img = next(mesh_rgb.render_flat(cams.get_subset_cameras([1])))
    ref = next(jmesh_rgb.render_flat(jcams.get_subset_cameras([1]), config=XLA))
    same = got_p2f[1] == want_p2f[1]
    np.testing.assert_array_equal(img[same], ref[same])
    with pytest.raises(ValueError, match="no texture"):
        next(interop.mesh_from_jax(JaxTexturedMesh(jmesh), device="cpu").render_flat(cams))
    # batch_size is accepted and changes nothing, as in the JAX package
    np.testing.assert_array_equal(next(mesh.render_flat(cams, batch_size=2)),
                                  renders[0][0])


def test_capacity_overflow_is_not_silent(scene):
    _, _, mesh, cams = scene
    small = RasterConfig(caps=(24, 8, 4, 4))
    assert mesh.check_raster_capacity(cams, 1, config=small) > 0
    renders = mesh.render_flat(cams, config=small)
    for _ in range(len(cams)):  # every view is yielded first
        next(renders)
    with pytest.raises(RuntimeError, match="capacity overflow"):
        next(renders)
    with pytest.raises(RuntimeError, match="capacity overflow"):
        mesh.pix2face(cams, config=small)
    with pytest.raises(RuntimeError, match="capacity overflow"):
        mesh._pix2face_device(cams, 1, config=small)


def decode(path):
    return cv2.imread(str(path), cv2.IMREAD_UNCHANGED)


@pytest.mark.parametrize("scale,native", [(1.0, True), (0.5, True), (0.5, False)])
def test_save_renders_matches_jax(scene, tmp_path, scale, native):
    """One mask a camera, named after its image; the decoded files equal
    the JAX package's wherever the two pix2face maps agree."""
    jmesh, jcams, mesh, cams = scene
    kw = dict(render_image_scale=scale, save_native_resolution=native)
    mesh.save_renders(cams, output_folder=tmp_path / "t", **kw)
    jmesh.save_renders(jcams, output_folder=tmp_path / "j", config=XLA, **kw)
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == [f"view_{k}.png" for k in range(4)]
    want_p2f = jmesh.pix2face(jcams, render_img_scale=scale, config=XLA)
    got_p2f = mesh.pix2face(cams, render_img_scale=scale)
    size = (H, W) if native or scale == 1.0 else (int(H * scale), int(W * scale))
    for k, name in enumerate(names):
        ours = read_image_or_numpy(tmp_path / "t" / name)
        theirs = decode(tmp_path / "j" / name)
        np.testing.assert_array_equal(decode(tmp_path / "t" / name), ours)
        assert ours.shape == theirs.shape == size and ours.dtype == np.uint8
        same = (got_p2f[k] == want_p2f[k]).astype(np.uint8)
        same = cv2.resize(same, size[::-1], interpolation=cv2.INTER_NEAREST) > 0
        np.testing.assert_array_equal(ours[same], theirs[same])
        assert same.mean() >= 0.99
        assert (ours == 255).any() and len(np.unique(ours)) >= 4


def test_save_renders_other_outputs(scene, tmp_path):
    """.npy renders, three-channel masks in cv2's channel order, and the
    refusals."""
    jmesh, jcams, mesh, cams = scene
    one, jone = cams.get_subset_cameras([2]), jcams.get_subset_cameras([2])
    mesh.save_renders(one, output_folder=tmp_path / "t", output_extension=".npy",
                      render_image_scale=0.5)
    jmesh.save_renders(jone, output_folder=tmp_path / "j", output_extension=".npy",
                       render_image_scale=0.5, config=XLA)
    ours, theirs = np.load(tmp_path / "t" / "view_2.npy"), np.load(tmp_path / "j" / "view_2.npy")
    assert ours.shape == theirs.shape == (H, W) and ours.dtype == theirs.dtype
    assert np.isclose(ours, theirs, equal_nan=True).mean() >= 0.99
    rgb = np.random.default_rng(7).random((mesh.n_faces, 3)) * 300 - 20
    mesh_rgb = interop.mesh_from_jax(jmesh, device="cpu")
    mesh_rgb.raster_config = mesh.raster_config
    jmesh_rgb = JaxTexturedMesh(jmesh)
    for m in (mesh_rgb, jmesh_rgb):
        m.set_texture(rgb)
    mesh_rgb.save_renders(one, output_folder=tmp_path / "t3")
    jmesh_rgb.save_renders(jone, output_folder=tmp_path / "j3", config=XLA)
    ours, theirs = decode(tmp_path / "t3" / "view_2.png"), decode(tmp_path / "j3" / "view_2.png")
    assert ours.shape == theirs.shape == (H, W, 3)
    assert (ours == theirs).all(axis=-1).mean() >= 0.99
    assert (ours == 0).any() and (ours == 255).any()  # clipped both ways
    # composites are ported (tests/test_torch_viewers.py): a view whose
    # image is missing gets its mask and no composite, as in the JAX package
    mesh.save_renders(one, output_folder=tmp_path / "x", make_composites=True)
    jmesh.save_renders(jone, output_folder=tmp_path / "jx", make_composites=True,
                       config=XLA)
    assert sorted(p.name for p in (tmp_path / "x").iterdir()) == ["view_2.png"]
    assert sorted(p.name for p in (tmp_path / "jx").iterdir()) == ["view_2.png"]
    with pytest.raises(ValueError, match="cast_to_uint8"):
        mesh.save_renders(one, output_folder=tmp_path / "x", cast_to_uint8=False)


class SoftSegmentor:
    """Prepared float images by camera index, for either package's
    segmentor camera set."""

    needs_image = False

    def __init__(self, images):
        self.images = images

    def segment_image(self, image, filename=None, image_scale=1.0, index=None, **kw):
        return self.images[index]


def test_soft_images_of_a_distorted_sensor_aggregate(scene):
    """``project_images`` of soft (non-one-hot) images, the last through
    the Brown-Conrady sensor (the pinhole render and its nearest-neighbour
    remap): per-face sums and counts equal the JAX package's to
    ``rtol=1e-6``, NaN for NaN, on every face that no disagreeing pix2face
    pixel touches."""
    from geograypher_tpu_torch.cameras.segmentor_set import SegmentorCameraSet

    jmesh, jcams, mesh, cams = scene
    rng = np.random.default_rng(8)
    soft = rng.random((4, H, W, 3)).astype(np.float32)
    soft /= soft.sum(axis=-1, keepdims=True)
    soft[:, :5, :7] = np.nan
    jseg = JaxSegmentorCameraSet(jcams, SoftSegmentor(soft))
    seg = SegmentorCameraSet(cams, SoftSegmentor(soft))
    want_p2f = jmesh.pix2face(jcams, config=XLA)
    got_p2f = mesh.pix2face(cams)
    assert (got_p2f[3] != mesh.pix2face(cams, [3], apply_distortion=False)[0]).any()
    views = zip(mesh.project_images(seg), jmesh.project_images(jseg, config=XLA))
    for k, ((sums, counts), (jsums, jcounts)) in enumerate(views):
        differ = got_p2f[k] != want_p2f[k]
        touched = np.zeros(mesh.n_faces + 1, bool)
        touched[got_p2f[k][differ]] = True
        touched[want_p2f[k][differ]] = True
        clean = ~touched[:-1]
        assert clean.mean() > 0.9
        np.testing.assert_array_equal(counts.numpy()[clean], np.asarray(jcounts)[clean])
        np.testing.assert_allclose(sums.numpy()[clean], np.asarray(jsums)[clean],
                                   rtol=1e-6, atol=0)
        assert (counts.numpy() > 0).any(axis=1).mean() > 0.3
    avg, info = mesh.aggregate_projected_images(seg)
    ref, ref_info = jmesh.aggregate_projected_images(jseg, use_planned=False, config=XLA)
    close = np.isclose(avg, ref, rtol=1e-5, atol=0, equal_nan=True).all(axis=1)
    assert close.mean() > 0.9
    np.testing.assert_array_equal(np.isnan(avg).all(axis=1),
                                  info["projection_counts"] == 0)


# -- the slice as a whole -------------------------------------------------------


@pytest.fixture(scope="module")
def survey(tmp_path_factory):
    return create_example_survey(tmp_path_factory.mktemp("survey"), device="cpu")


def test_render_labels_matches_jax_mesh(survey, tmp_path):
    """The port's entry point on the survey on disk against the JAX mesh
    (vector texture, inferred ROI, ``save_renders``) on its XLA raster."""
    mesh, cams = render_labels(
        mesh_file=survey["mesh_file"],
        cameras_file=survey["cameras_file"],
        image_folder=survey["image_folder"],
        texture=survey["labels_vector_file"],
        texture_column_name="species",
        render_savefolder=tmp_path / "t",
        ROI_buffer_radius_meters=8.0,
        cameras_ROI_buffer_radius_meters=25.0,
        subset_images_savefolder=tmp_path / "subset",
        textured_mesh_savefile=tmp_path / "textured.ply",
        device="cpu",
    )
    # every camera hovers within 25 m of a label polygon (the camera crop
    # is held against the JAX package in tests/test_torch_mesh_texture.py)
    jcams = JaxMetashape(survey["cameras_file"], survey["image_folder"])
    jmesh = JaxTexturedMesh(
        survey["mesh_file"], transform_filename=survey["cameras_file"],
        texture=survey["labels_vector_file"], texture_column_name="species",
        ROI=survey["labels_vector_file"], ROI_buffer_meters=8.0,
    )
    jmesh.save_renders(jcams, output_folder=tmp_path / "j", config=XLA)
    assert len(cams) == len(jcams) == 4
    assert mesh.IDs_to_labels == jmesh.IDs_to_labels
    assert 0 < mesh.n_faces < len(survey["face_labels"])
    # the crop: the same faces, but for those with a vertex in the band
    # where the exact buffer and the JAX package's raster buffer may part
    from geograypher_tpu_torch.meshes.mesh import TexturedMesh
    from geograypher_tpu_torch.utils.vector import VectorData
    from tests.test_torch_mesh_texture import _far_from_buffer_edge

    whole = TexturedMesh(survey["mesh_file"], transform_filename=survey["cameras_file"],
                         device="cpu")
    _, mask = whole.select_mesh_ROI(survey["labels_vector_file"], 8.0)
    _, jmask = JaxTexturedMesh(
        survey["mesh_file"], transform_filename=survey["cameras_file"]
    ).select_mesh_ROI(survey["labels_vector_file"], 8.0)
    assert mask.sum() == mesh.n_faces and jmask.sum() == jmesh.n_faces
    vd = VectorData.read_file(survey["labels_vector_file"])
    clear = _far_from_buffer_edge(
        vd.geometries, whole.get_vertices_in_CRS(vd.epsg)[:, :2], 8.0, 12.0 + 1e-9)
    face_clear = clear[whole.faces].all(axis=1)
    assert face_clear.mean() > 0.5
    np.testing.assert_array_equal(mask[face_clear], jmask[face_clear])
    assert sorted(p.name for p in (tmp_path / "subset").iterdir()) == \
        [f"img_{k:04d}.png" for k in range(4)]
    assert (tmp_path / "textured.ply").exists()
    for k in range(4):
        ours = read_image_or_numpy(tmp_path / "t" / f"img_{k:04d}.png")
        theirs = decode(tmp_path / "j" / f"img_{k:04d}.png")
        assert ours.shape == theirs.shape == (96, 96) and ours.dtype == np.uint8
        assert (ours == theirs).mean() >= 0.99
        assert set(np.unique(ours)) <= {0, 1, 2, 255} and len(np.unique(ours)) >= 3
    # chunked (two camera clusters; the 125 m chunk buffer covers the
    # scene): the same files
    render_labels(
        mesh_file=survey["mesh_file"], cameras_file=survey["cameras_file"],
        image_folder=survey["image_folder"], texture=survey["labels_vector_file"],
        texture_column_name="species", render_savefolder=tmp_path / "c",
        ROI_buffer_radius_meters=8.0, cameras_ROI_buffer_radius_meters=25.0,
        n_cameras_per_chunk=2, device="cpu")
    for k in range(4):
        name = f"img_{k:04d}.png"
        np.testing.assert_array_equal(read_image_or_numpy(tmp_path / "c" / name),
                                      read_image_or_numpy(tmp_path / "t" / name))
    # DTM_file is ported since A6 (tests/test_torch_dtm.py), composites and
    # vis since A9's rest (tests/test_torch_viewers.py): vis is accepted and
    # read nowhere, composites join the masks
    for kw, composites in ((dict(make_composites=True), True), (dict(vis=True), False)):
        out = tmp_path / f"x_{composites}"
        render_labels(survey["mesh_file"], survey["cameras_file"],
                      survey["image_folder"], survey["labels_vector_file"],
                      out, device="cpu", **kw)
        want = [f"img_{k:04d}.png" for k in range(4)]
        if composites:
            want += [f"img_{k:04d}_composite.png" for k in range(4)]
        assert sorted(p.name for p in out.iterdir()) == sorted(want)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            render_labels(survey["mesh_file"], survey["cameras_file"],
                          survey["image_folder"], survey["labels_vector_file"],
                          tmp_path / "x")


def test_render_then_aggregate_round_trip(survey, tmp_path):
    """Face labels -> ``render_labels`` masks -> ``aggregate_images`` ->
    the labels come back, through both entry points of the port."""
    labels = survey["face_labels"].astype(float)
    np.save(tmp_path / "labels.npy", labels)
    mesh, cams = render_labels(
        survey["mesh_file"], survey["cameras_file"], survey["image_folder"],
        texture=tmp_path / "labels.npy", render_savefolder=tmp_path / "renders",
        device="cpu",
    )
    assert mesh.n_faces == len(labels) and len(cams) == 4
    pred, avg = aggregate_images(
        survey["mesh_file"], survey["cameras_file"], survey["image_folder"],
        label_folder=tmp_path / "renders", take_every_nth_camera=None,
        n_classes=survey["n_classes"], device="cpu",
    )
    observed = np.isfinite(pred)
    assert observed.mean() > 0.4
    assert (pred[observed] == labels[observed]).mean() > 0.95
    # cropped to an ROI: fewer faces, the same agreement
    roi = survey["labels_vector_file"]
    pred_roi, _ = aggregate_images(
        survey["mesh_file"], survey["cameras_file"], survey["image_folder"],
        label_folder=tmp_path / "renders", take_every_nth_camera=None,
        n_classes=survey["n_classes"], ROI=roi, ROI_buffer_radius_meters=8.0,
        device="cpu",
    )
    from geograypher_tpu_torch.meshes.mesh import TexturedMesh

    cropped, face_mask = TexturedMesh(
        survey["mesh_file"], transform_filename=survey["cameras_file"], device="cpu",
    ).select_mesh_ROI(roi, 8.0)
    assert len(pred_roi) == cropped.n_faces < len(labels)
    seen = np.isfinite(pred_roi)
    assert (pred_roi[seen] == labels[face_mask][seen]).mean() > 0.95
