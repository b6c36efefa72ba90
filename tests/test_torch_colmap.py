"""The port's COLMAP text parser (``geograypher_tpu_torch/cameras/
colmap.py``) against the JAX package's pandas one: the JAX tests' files,
real COLMAP layouts (an empty POINTS2D line, two sensors, CRLF line ends,
no final newline), the unsupported-model error, and a small aggregation
through both COLMAP sets.  Sensors are compared exactly, poses to 1e-12
(pandas parses some 17-digit floats one ulp off, ROADMAP C4)."""

import dataclasses

import numpy as np
import pandas as pd
import pytest

from geograypher_tpu.cameras.colmap import COLMAPCameraSet as JaxCOLMAP
from geograypher_tpu.cameras.segmentor_set import (
    SegmentorCameraSet as JaxSegmentorCameraSet,
)
from geograypher_tpu.meshes.mesh import TexturedMesh as JaxTexturedMesh
from geograypher_tpu.ops.rasterize import RasterConfig as JaxRasterConfig
from geograypher_tpu.predictors.segmentors import ArraySegmentor as JaxArraySegmentor
from geograypher_tpu_torch import interop
from geograypher_tpu_torch.cameras.colmap import COLMAPCameraSet
from geograypher_tpu_torch.cameras.segmentor_set import SegmentorCameraSet
from geograypher_tpu_torch.meshes.mesh import TexturedMesh
from geograypher_tpu_torch.predictors.segmentors import ArraySegmentor
from geograypher_tpu_torch.utils.fixtures import make_grid_mesh, nadir_camera, oblique_camera
from tests.test_cameras import make_colmap_files
from tests.test_torch_pipeline import swapped_faces
from tests.test_torch_rasterize import one_torch_thread  # noqa: F401

POSE_ATOL = 1e-12
CAMERAS_HEADER = ("# Camera list with one line of data per camera:\n"
                  "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n"
                  "# Number of cameras: {n}\n")
IMAGES_HEADER = ("# Image list with two lines of data per image:\n"
                 "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
                 "#   POINTS2D[] as (X, Y, POINT3D_ID)\n"
                 "# Number of images: {n}, mean observations per image: 1\n")


def quaternion_wxyz(rot: np.ndarray) -> np.ndarray:
    """A rotation matrix's unit quaternion (w, x, y, z), w >= 0."""
    m = np.asarray(rot, np.float64)
    # Shepperd's method: divide by the largest component, so none is the
    # square root of a cancellation (~1e-8 where it should be 0)
    t = np.trace(m)
    k = int(np.argmax([t, m[0, 0], m[1, 1], m[2, 2]]))
    if k == 0:
        s = 2 * np.sqrt(1 + t)
        q = [s / 4, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s]
    elif k == 1:
        s = 2 * np.sqrt(1 + m[0, 0] - m[1, 1] - m[2, 2])
        q = [(m[2, 1] - m[1, 2]) / s, s / 4, (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s]
    elif k == 2:
        s = 2 * np.sqrt(1 - m[0, 0] + m[1, 1] - m[2, 2])
        q = [(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, s / 4, (m[1, 2] + m[2, 1]) / s]
    else:
        s = 2 * np.sqrt(1 - m[0, 0] - m[1, 1] + m[2, 2])
        q = [(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s, (m[1, 2] + m[2, 1]) / s, s / 4]
    q = np.array(q) * (1.0 if q[0] >= 0 else -1.0)
    return q / np.linalg.norm(q)


def write_colmap(folder, c2ws, sensors, sensor_ids, points_lines, newline="\n",
                 final_newline=True):
    """cameras.txt and images.txt as COLMAP writes them (17 significant
    digits), the world -> camera poses of ``c2ws``; ``points_lines[k]``
    is image k's POINTS2D line ("" for an image with no points)."""
    cams = CAMERAS_HEADER.format(n=len(sensors)) + "".join(
        f"{cid} SIMPLE_RADIAL {s['w']} {s['h']} {s['f']!r} {s['cx']!r} {s['cy']!r} "
        f"{s['k']!r}\n" for cid, s in sensors.items())
    lines = []
    for k, c2w in enumerate(c2ws):
        w2c = np.linalg.inv(c2w)
        q = quaternion_wxyz(w2c[:3, :3])
        values = " ".join(f"{v:.17g}" for v in (*q, *w2c[:3, 3]))
        lines.append(f"{k + 1} {values} {sensor_ids[k]} img_{k:02d}.png")
        lines.append(points_lines[k])
    images = IMAGES_HEADER.format(n=len(c2ws)) + "\n".join(lines)
    if final_newline:
        images += "\n"
    (folder / "cameras.txt").write_bytes(cams.replace("\n", newline).encode())
    (folder / "images.txt").write_bytes(images.replace("\n", newline).encode())
    return folder / "cameras.txt", folder / "images.txt"


def assert_same_set(ours, theirs):
    assert len(ours) == len(theirs) > 0
    assert ours.sensors == theirs.sensors
    assert ours.sensor_IDs == theirs.sensor_IDs
    assert ours.image_filenames == theirs.image_filenames
    for a, b in zip(ours.cam_to_world_transforms, theirs.cam_to_world_transforms):
        np.testing.assert_allclose(a, b, rtol=0, atol=POSE_ATOL)


def test_the_jax_test_files(tmp_path):
    cameras_txt, images_txt = make_colmap_files(tmp_path)
    ours = COLMAPCameraSet(cameras_txt, images_txt, image_folder=tmp_path)
    assert_same_set(ours, JaxCOLMAP(cameras_txt, images_txt, image_folder=tmp_path))
    assert ours.sensors[1] == {"image_width": 640, "image_height": 480, "f": 500.0,
                               "cx": 0.0, "cy": 0.0, "distortion_params": {"k1": -0.05}}
    np.testing.assert_allclose(ours.cam_to_world_transforms[0][:3, 3], [0, 0, 5])
    assert ours.get_camera_batch(device="cpu").image_width == 640
    without = COLMAPCameraSet(cameras_txt, images_txt)
    assert without.image_filenames == [None, None]


def suite(n=5, seed=0):
    """``n`` seeded cameras over the 4 m scene and two sensors."""
    rng = np.random.default_rng(seed)
    c2ws = [nadir_camera(4.0, 60.0, 96)] + [
        oblique_camera(4.0, 70.0, 96, pitch_deg=float(p), azimuth_deg=float(a))
        for p, a in zip(rng.uniform(10, 35, n - 1), rng.uniform(0, 360, n - 1))]
    # principal points off the half-pixel grid: at an offset of exactly
    # 0.5 px every pixel centre of a remap lands on a rounding tie
    sensors = {1: dict(w=96, h=64, f=60.0, cx=48.3, cy=31.9, k=0.0),
               7: dict(w=96, h=64, f=70.0, cx=47.6, cy=32.2, k=-0.03125)}
    return c2ws, sensors, [1, 7, 7, 1, 7][:n]


@pytest.mark.parametrize("layout", ["points", "empty_points", "crlf", "no_final_newline"])
def test_colmap_layouts_match_jax(tmp_path, layout):
    c2ws, sensors, ids = suite()
    points = ["12.5 3.25 7 40.0 2.0 -1"] * len(c2ws)
    if layout != "points":
        points[1] = points[3] = ""  # images with no points
    paths = write_colmap(tmp_path, c2ws, sensors, ids, points,
                         newline="\r\n" if layout == "crlf" else "\n",
                         final_newline=layout != "no_final_newline")
    ours = COLMAPCameraSet(*paths, image_folder=tmp_path)
    assert_same_set(ours, JaxCOLMAP(*paths, image_folder=tmp_path))
    assert len(ours) == len(c2ws) and sorted(ours.sensors) == [1, 7]
    assert ours.sensors[7]["cx"] == 47.6 - 48 and ours.sensors[7]["cy"] == 32.2 - 32
    assert ours.sensors[7]["distortion_params"] == {"k1": -0.03125}
    for got, want in zip(ours.cam_to_world_transforms, c2ws):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_unsupported_model_raises_in_both(tmp_path):
    cameras_txt, images_txt = make_colmap_files(tmp_path)
    cameras_txt.write_text("#\n#\n#\n1 OPENCV 640 480 500.0 320.0 240.0 -0.05\n")
    for cls in (COLMAPCameraSet, JaxCOLMAP):
        with pytest.raises(NotImplementedError):
            cls(cameras_txt, images_txt, image_folder=tmp_path)


def test_floats_parse_correctly_rounded(tmp_path):
    """The port parses a pose's floats as Python does (correctly
    rounded); pandas lands one ulp off on some 17-digit values, the
    distance held to ``POSE_ATOL`` above."""
    rng = np.random.default_rng(5)
    values = rng.normal(size=4000) * 100
    text = "\n".join(f"{v:.17g}" for v in values) + "\n"
    (tmp_path / "v.txt").write_text(text)
    pandas = pd.read_csv(tmp_path / "v.txt", header=None)[0].to_numpy()
    exact = np.array([float(t) for t in text.split()])
    np.testing.assert_array_equal(exact, values)
    assert np.abs(pandas - exact).max() <= np.abs(np.spacing(exact)).max()
    c2ws, sensors, ids = suite(n=3, seed=5)
    paths = write_colmap(tmp_path, c2ws, sensors, ids, [""] * 3)
    ours = COLMAPCameraSet(*paths)
    w2c = np.linalg.inv(c2ws[2])
    q = quaternion_wxyz(w2c[:3, :3])
    tokens = (tmp_path / "images.txt").read_text().split("\n")[8].split(" ")
    assert [float(t) for t in tokens[1:5]] == [float(f"{v:.17g}") for v in q]
    np.testing.assert_allclose(ours.cam_to_world_transforms[2], c2ws[2], atol=1e-12)


def test_aggregation_through_colmap_matches_jax(tmp_path):
    """A small aggregation through both packages' COLMAP sets (distorted
    sensor included): view counts and summed fractions equal on every
    face no knife-edge swap touches, the swapped faces a few."""
    c2ws, sensors, ids = suite()
    paths = write_colmap(tmp_path, c2ws, sensors, ids, [""] * len(c2ws))
    verts, faces = make_grid_mesh(n=25, size=4.0,
                                  z_fn=lambda x, y: 0.15 * np.sin(3 * x) * np.cos(2 * y))
    labels = np.random.default_rng(1).integers(0, 3, (len(c2ws), 64, 96))
    # the Pallas backend (interpret mode here): the JAX streaming loop then
    # rasterizes a distorted sensor in distorted space, as the port's does
    # (on XLA it remaps a pinhole raster, ROADMAP C4)
    jcfg = JaxRasterConfig(caps=(512, 128, 64, 32), backend="pallas")
    jcams = JaxCOLMAP(*paths, image_folder=tmp_path)
    tcams = COLMAPCameraSet(*paths, image_folder=tmp_path)
    jmesh = JaxTexturedMesh((verts, faces), raster_config=jcfg)
    tmesh = TexturedMesh((verts, faces), device="cpu",
                         raster_config=interop.raster_config_from_jax(jcfg))
    _, jinfo = jmesh.aggregate_projected_images(
        JaxSegmentorCameraSet(jcams, JaxArraySegmentor(labels, 3)))
    _, tinfo = tmesh.aggregate_projected_images(
        SegmentorCameraSet(tcams, ArraySegmentor(labels, 3)), use_planned=False)
    swapped, differ = swapped_faces(jmesh, jcams, tmesh, tcams,
                                    dataclasses.replace(jcfg, subtile=None))
    keep = ~swapped
    assert swapped.sum() <= 0.02 * len(faces) and differ < 0.01
    np.testing.assert_array_equal(tinfo["projection_counts"][keep],
                                  jinfo["projection_counts"][keep])
    np.testing.assert_allclose(tinfo["summed_projections"][keep],
                               jinfo["summed_projections"][keep], rtol=0, atol=1e-5)
    assert (tinfo["projection_counts"][keep] > 0).mean() > 0.5
