"""The port's 360-rig workflow against the JAX package: the perspective
resample of an equirectangular panorama against cv2's (uint8 and float32,
oversampled or not; the sampled mask exactly), EXIF GPS against PIL, the
camera-side rotation, the rig fan-out, and the under-canopy survey at
``n_stations=2, sensor=96``: the same mesh, labels, cameras and images as
the JAX generator's, and the labels recovered through the rig as
``tests/test_rig_e2e.py`` recovers them."""

import numpy as np
import pytest
import torch
from PIL import Image

from geograypher_tpu.cameras.rig import (
    create_rig_cameras_from_equirectangular as jax_rig_cameras,
)
from geograypher_tpu.utils import example_data as jex
from geograypher_tpu.utils import image as jimage
from geograypher_tpu_torch.cameras.rig import create_rig_cameras_from_equirectangular
from geograypher_tpu_torch.cameras.segmentor_set import SegmentorCameraSet
from geograypher_tpu_torch.meshes.mesh import TexturedMesh
from geograypher_tpu_torch.ops.aggregate import find_argmax_nonzero_value
from geograypher_tpu_torch.parallel.planner import census_caps
from geograypher_tpu_torch.predictors.segmentors import LookUpSegmentor
from geograypher_tpu_torch.utils import example_data as tex
from geograypher_tpu_torch.utils import image as timage
from geograypher_tpu_torch.utils.io import read_image_or_numpy
from geograypher_tpu_torch.utils.meshio import load_mesh
from tests.test_torch_rasterize import knife_edge, one_torch_thread  # noqa: F401

# the port interpolates in float32 at the exact sampling position, as cv2
# 5's remap does with float maps: float32 views agree to float32 rounding of
# 0-255 values, uint8 views exactly; an oversampled uint8 view differs by
# the area downsample's rounding (utils/io.py resize_area, +-1)
RESAMPLE_ATOL = {(np.uint8, 1.0): 0, (np.uint8, 1.5): 1,
                 (np.float32, 1.0): 1e-4, (np.float32, 1.5): 1e-4}
ORIENTATIONS = [(0.0, 0.0, 0.0), (0.0, -90.0, 0.0), (12.0, 35.0, 170.0),
                (-5.0, 80.0, -60.0)]


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("oversample", [1.0, 1.5])
def test_perspective_resample_matches_cv2(dtype, oversample):
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:100, 0:200]
    smooth = np.stack([255 * xx / 200, 255 * yy / 100, 0 * xx + 96], -1)
    pano = np.concatenate([smooth[:, :100], rng.integers(0, 256, (100, 100, 3))],
                          axis=1).astype(dtype)
    for roll, pitch, yaw in ORIENTATIONS:
        got, got_mask = timage.perspective_from_equirectangular(
            pano, roll, pitch, yaw, fov_deg=80.0, out_size=(45, 77),
            oversample=oversample, return_sampled_mask=True)
        want, want_mask = jimage.perspective_from_equirectangular(
            pano, roll, pitch, yaw, fov_deg=80.0, out_size=(45, 77),
            oversample=oversample, return_sampled_mask=True)
        assert got.dtype == want.dtype and got.shape == want.shape == (45, 77, 3)
        np.testing.assert_allclose(got.astype(float), want.astype(float), rtol=0,
                                   atol=RESAMPLE_ATOL[dtype, oversample])
        np.testing.assert_array_equal(got_mask, want_mask)
        assert want_mask.any()
    gray = pano[..., 0]
    np.testing.assert_allclose(
        timage.perspective_from_equirectangular(gray, 0, 10, 30, out_size=(20, 20)),
        jimage.perspective_from_equirectangular(gray, 0, 10, 30, out_size=(20, 20)),
        rtol=0, atol=RESAMPLE_ATOL[dtype, 1.0])


def test_rotate_by_roll_pitch_yaw_matches_jax():
    c2w = np.eye(4)
    c2w[:3, 3] = (1.0, -2.0, 3.0)
    for rpy in ORIENTATIONS:
        np.testing.assert_array_equal(timage.rotate_by_roll_pitch_yaw(c2w, *rpy),
                                      jimage.rotate_by_roll_pitch_yaw(c2w, *rpy))


def write_jpeg(path, gps=None):
    exif = Image.Exif()
    exif[0x0110] = "synthetic"  # IFD0 Model
    if gps is not None:
        exif[0x8825] = gps
    Image.fromarray(np.full((8, 8, 3), 90, np.uint8)).save(path, exif=exif.tobytes())


@pytest.mark.parametrize("case", ["north_west", "south_east", "no_gps", "no_refs",
                                  "not_an_image", "missing", "png"])
def test_gps_exif_matches_pil(tmp_path, case):
    path = tmp_path / "img.jpg"
    if case == "north_west":
        write_jpeg(path, {1: "N", 2: (36.0, 57.0, 12.345), 3: "W", 4: (119.0, 3.0, 1.5)})
    elif case == "south_east":
        write_jpeg(path, {1: "S", 2: (33.0, 51.0, 54.0), 3: "E", 4: (151.0, 12.0, 36.25)})
    elif case == "no_gps":
        write_jpeg(path)
    elif case == "no_refs":
        write_jpeg(path, {2: (36.0, 57.0, 12.0), 4: (119.0, 3.0, 1.0)})
    elif case == "not_an_image":
        path.write_bytes(b"plain text")
    elif case == "png":
        path = tmp_path / "img.png"
        Image.fromarray(np.zeros((4, 4), np.uint8)).save(path)
    got, want = timage.get_GPS_exif(path), jimage.get_GPS_exif(path)
    assert got == want
    assert (got is not None) == (case in ("north_west", "south_east"))
    if case == "north_west":
        assert got[0] < 0 < got[1]


@pytest.fixture(scope="module")
def surveys(tmp_path_factory):
    port = tex.create_undercanopy_survey(tmp_path_factory.mktemp("port"), n_stations=2,
                                         sensor=96, device="cpu")
    jax = jex.create_undercanopy_survey(tmp_path_factory.mktemp("jax"), n_stations=2,
                                        sensor=96)
    return port, jax


def rig_of(survey, fn, folder_key):
    return fn(
        camera_file=survey["cameras_file"],
        original_images=survey["equirect_folder"],
        perspective_images=survey[folder_key],
        rig_camera=survey["rig_camera"],
        rig_orientations=survey["rig_orientations"],
        perspective_filename_format_str=survey["format_str"],
    )


def test_rig_fanout_matches_jax(surveys):
    port, jax = surveys
    ours = rig_of(port, create_rig_cameras_from_equirectangular, "perspective_folder")
    theirs = rig_of(port, jax_rig_cameras, "perspective_folder")
    assert len(ours) == len(theirs) == 12
    for a, b in zip(ours.cam_to_world_transforms, theirs.cam_to_world_transforms):
        np.testing.assert_array_equal(a, b)
    assert ours.image_filenames == theirs.image_filenames
    assert ours.sensors == theirs.sensors and ours.sensor_IDs == theirs.sensor_IDs
    np.testing.assert_array_equal(ours.get_local_to_epsg_4978_transform(),
                                  theirs.get_local_to_epsg_4978_transform())
    assert ours.image_filenames[4].name == "pano_0000_yaw000_pitch-90.png"
    assert all(f.exists() for f in ours.image_filenames)


def test_undercanopy_survey_matches_jax(surveys):
    """The same mesh, face labels and cameras; the panoramas and the
    perspective views decode to the JAX files' pixels (the uint8 resample
    is exact); the rendered predictions meet the knife-edge contract."""
    port, jax = surveys
    for key in ("face_labels", "local_to_ecef"):
        np.testing.assert_array_equal(port[key], jax[key])
    assert port["n_classes"] == jax["n_classes"] and port["rig_camera"] == jax["rig_camera"]
    assert port["rig_orientations"] == jax["rig_orientations"]
    assert port["format_str"] == jax["format_str"]
    assert port["cameras_file"].read_text() == jax["cameras_file"].read_text().replace(
        str(jax["equirect_folder"]), str(port["equirect_folder"]))
    for got, want in zip(load_mesh(port["mesh_file"])[:2], load_mesh(jax["mesh_file"])[:2]):
        np.testing.assert_array_equal(got, want)
    for folder in ("equirect_folder", "perspective_folder", "prediction_folder"):
        names = sorted(p.name for p in port[folder].iterdir())
        assert names == sorted(p.name for p in jax[folder].iterdir()) and names
        for name in names:
            got = read_image_or_numpy(port[folder] / name)
            want = read_image_or_numpy(jax[folder] / name)
            assert got.shape == want.shape and got.dtype == want.dtype
            if folder == "prediction_folder":
                knife_edge(np.where(got == 255, -1, got), np.where(want == 255, -1, want))
            else:
                np.testing.assert_array_equal(got, want)


def test_port_survey_recovers_the_labels(surveys):
    """``tests/test_rig_e2e.py``'s check on the port: every seen face's
    label recovered, most faces seen, two canopy classes observed."""
    port, _ = surveys
    rig = rig_of(port, create_rig_cameras_from_equirectangular, "prediction_folder")
    mesh = TexturedMesh(port["mesh_file"], transform_filename=port["cameras_file"],
                        device="cpu")
    mesh.raster_config = census_caps(mesh.view_raster_census(rig), mesh.raster_config)
    seg = SegmentorCameraSet(rig, LookUpSegmentor(
        port["prediction_folder"], port["prediction_folder"], port["n_classes"]))
    averaged, _ = mesh.aggregate_projected_images(seg)
    face_classes = find_argmax_nonzero_value(torch.as_tensor(averaged)).numpy()
    truth = port["face_labels"].astype(float)
    seen = np.isfinite(face_classes)
    assert seen.sum() > 0.5 * len(truth)
    assert float(np.mean(face_classes[seen] == truth[seen])) == 1.0
    observed = set(np.unique(face_classes[seen]).astype(int))
    assert len(observed & set(range(1, port["n_classes"]))) >= 2
