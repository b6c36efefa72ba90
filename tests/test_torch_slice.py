"""The whole aggregation slice: the PyTorch port's
``TexturedMesh.aggregate_projected_images`` against the JAX package's on
the same in-memory survey, carried across by ``interop`` (CPU; JAX Pallas
in interpret mode).  The JAX side is held through its mesh method, not
its entrypoint, whose multi-device branch the 8 virtual test devices
would take."""

import numpy as np
import pytest
import torch

from geograypher_tpu.cameras.core import CameraSet as JaxCameraSet
from geograypher_tpu.cameras.segmentor_set import (
    SegmentorCameraSet as JaxSegmentorCameraSet,
)
from geograypher_tpu.meshes.mesh import TexturedMesh as JaxTexturedMesh
from geograypher_tpu.ops.rasterize import RasterConfig as JaxRasterConfig
from geograypher_tpu.predictors.segmentors import ArraySegmentor
from geograypher_tpu.utils.fixtures import make_grid_mesh, nadir_camera, oblique_camera
from geograypher_tpu_torch import interop
from geograypher_tpu_torch.ops.aggregate import find_argmax_nonzero_value

N_CLASSES = 5
W, H = 128, 96
XLA = JaxRasterConfig(caps=(256, 96, 48, 32), backend="xla")


def predicted(avg):
    """Per-face class as the entrypoint computes it; NaN where unseen."""
    out = find_argmax_nonzero_value(
        torch.as_tensor(np.nan_to_num(avg), dtype=torch.float32)
    ).numpy()
    out[np.isnan(avg).all(axis=1)] = np.nan
    return out


@pytest.fixture(scope="module")
def survey():
    """Grid mesh (1,568 faces) and 4 views: two nadir, two oblique, the
    last through a Brown-Conrady sensor; seeded one-hot labels with a few
    unlabelled pixels."""
    verts, faces = make_grid_mesh(
        n=29, size=4.0, z_fn=lambda x, y: 0.15 * np.sin(3 * x) * np.cos(2 * y)
    )
    jmesh = JaxTexturedMesh((verts, faces))
    jmesh.spatial_sort_faces()
    c2ws = [
        nadir_camera(4.0, 60.0, W),
        oblique_camera(4.0, 70.0, W, pitch_deg=25.0, azimuth_deg=30.0),
        nadir_camera(4.0, 70.0, W),
        oblique_camera(4.0, 60.0, W, pitch_deg=30.0, azimuth_deg=200.0),
    ]
    # off the pixel grid: a nadir camera centred on the grid mesh puts
    # pixel centres exactly on shared edges, where float32 rounding alone
    # picks the face (the knife-edge pixels of the raster contract)
    c2ws[0][:3, 3] += (0.0123, -0.0217, 0.031)
    c2ws[2][:3, 3] += (0.3061, -0.1987, 0.0)
    sensors = {
        0: {"f": 60.0, "cx": 0.0, "cy": 0.0, "image_width": W, "image_height": H},
        1: {"f": 70.0, "cx": 0.0, "cy": 0.0, "image_width": W, "image_height": H},
        2: {"f": 60.0, "cx": 0.5, "cy": -0.5, "image_width": W, "image_height": H,
            "distortion_params": {"k1": 0.02, "k2": -0.01, "p1": 1e-3}},
    }
    rng = np.random.default_rng(0)
    labels = rng.integers(-1, N_CLASSES, (4, H, W))  # -1: unlabelled
    jcams = JaxSegmentorCameraSet(
        JaxCameraSet(c2ws, sensors, sensor_IDs=[0, 1, 1, 2]),
        ArraySegmentor(labels, N_CLASSES),
    )
    return jmesh, jcams


def test_slice_matches_jax_xla(survey):
    jmesh, jcams = survey
    jcams = jcams.get_subset_cameras([0, 1, 2])  # the pinhole views
    ref, ref_info = jmesh.aggregate_projected_images(
        jcams, use_planned=False, config=XLA
    )
    mesh = interop.mesh_from_jax(jmesh)
    avg, info = mesh.aggregate_projected_images(
        interop.cameras_from_jax(jcams),
        config=interop.raster_config_from_jax(XLA),
    )
    assert avg.shape == ref.shape == (jmesh.n_faces, N_CLASSES)
    np.testing.assert_allclose(avg, ref, rtol=1e-6, equal_nan=True)
    np.testing.assert_array_equal(info["projection_counts"],
                                  ref_info["projection_counts"])
    np.testing.assert_array_equal(predicted(avg), predicted(ref))
    assert np.isfinite(avg).all(axis=1).mean() > 0.5
    _, every = mesh.aggregate_projected_images(
        interop.cameras_from_jax(jcams),
        config=interop.raster_config_from_jax(XLA), return_all=True,
    )
    assert len(every["all_projections"]) == len(jcams)
    per_view = np.stack(every["all_projections"])
    seen = ~np.isnan(per_view).all(axis=(0, 2))
    np.testing.assert_allclose(
        np.nanmean(per_view[:, seen], axis=0), avg[seen], rtol=1e-5
    )


def test_check_raster_capacity_matches_jax(survey):
    jmesh, jcams = survey
    small = JaxRasterConfig(caps=(24, 8, 4, 4), backend="xla")
    mesh = interop.mesh_from_jax(jmesh)
    cams = interop.cameras_from_jax(jcams)
    for i in (0, 1):
        want = jmesh.check_raster_capacity(jcams, i, config=small)
        assert want > 0
        assert mesh.check_raster_capacity(
            cams, i, config=interop.raster_config_from_jax(small)) == want


def test_slice_matches_jax_pallas(survey):
    jmesh, jcams = survey
    ref, _ = jmesh.aggregate_projected_images(jcams, use_planned=False)
    mesh = interop.mesh_from_jax(jmesh)
    avg, info = mesh.aggregate_projected_images(interop.cameras_from_jax(jcams))
    seen = info["projection_counts"] > 0
    np.testing.assert_array_equal(np.isnan(avg).all(axis=1), ~seen)
    np.testing.assert_array_equal(np.isnan(ref).all(axis=1), ~seen)
    ours, theirs = predicted(avg)[seen], predicted(ref)[seen]
    assert (ours == theirs).mean() >= 0.995
    np.testing.assert_allclose(np.nansum(avg[seen], axis=1), 1.0, atol=1e-5)


def test_planned_aggregation_not_ported(survey):
    jmesh, jcams = survey
    mesh = interop.mesh_from_jax(jmesh)
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        mesh.aggregate_projected_images(
            interop.cameras_from_jax(jcams), use_planned=True
        )


def test_batched_views_not_ported(survey):
    jmesh, jcams = survey
    mesh = interop.mesh_from_jax(jmesh)
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        mesh.aggregate_projected_images(
            interop.cameras_from_jax(jcams), batch_size=2
        )


def test_entrypoint_matches_jax_mesh(tmp_path):
    """The port's aggregate_images entrypoint (Metashape XML, PLY mesh,
    label images on disk) against the JAX mesh method on the same files."""
    from geograypher_tpu.cameras.metashape import MetashapeCameraSet
    from geograypher_tpu.predictors.segmentors import LookUpSegmentor
    from geograypher_tpu.utils.example_data import create_example_survey
    from geograypher_tpu_torch.entrypoints.aggregate_images import aggregate_images

    s = create_example_survey(tmp_path)
    pred, avg = aggregate_images(
        mesh_file=s["mesh_file"],
        cameras_file=s["cameras_file"],
        image_folder=s["image_folder"],
        label_folder=s["label_folder"],
        take_every_nth_camera=None,
        n_classes=s["n_classes"],
        device="cpu",
    )
    jmesh = JaxTexturedMesh(s["mesh_file"], transform_filename=s["cameras_file"])
    jcams = JaxSegmentorCameraSet(
        MetashapeCameraSet(s["cameras_file"], s["image_folder"],
                           validate_images=True),
        LookUpSegmentor(s["image_folder"], s["label_folder"], s["n_classes"]),
    )
    ref, _ = jmesh.aggregate_projected_images(jcams, use_planned=False, config=XLA)
    np.testing.assert_allclose(avg, ref, rtol=1e-6, equal_nan=True)
    np.testing.assert_array_equal(pred, predicted(ref))
    observed = np.isfinite(pred)
    assert observed.mean() > 0.4
    assert (pred[observed] == s["face_labels"][observed]).mean() > 0.95

    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        aggregate_images(s["mesh_file"], s["cameras_file"], s["image_folder"],
                         s["label_folder"], n_aggregation_clusters=2,
                         device="cpu")


def test_camera_batch_matches_jax(survey):
    _, jcams = survey
    cams = interop.cameras_from_jax(jcams)
    for scale in (1.0, 0.5):
        ref = jcams.get_camera_batch([3, 1], image_scale=scale)
        got = cams.get_camera_batch([3, 1], image_scale=scale)
        assert (got.image_width, got.image_height) == (ref.image_width,
                                                       ref.image_height)
        for name in ("cam_to_world", "world_to_cam", "f", "cx", "cy", "distortion"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(ref, name)))
    assert len(cams.get_subset_every_nth(2)) == 2
    assert cams.get_subset_cameras([2]).sensor_IDs == [1]


def test_aggregation_ops_match_jax():
    import jax.numpy as jnp

    from geograypher_tpu.ops import aggregate as ja
    from geograypher_tpu_torch.ops import aggregate as ta

    rng = np.random.default_rng(2)
    n_faces, c = 40, 3
    jstate, tstate = ja.init_aggregation(n_faces, c), ta.init_aggregation(n_faces, c)
    for _ in range(3):
        counts = rng.integers(0, 3, (n_faces, c)).astype(np.float32)
        sums = (counts * rng.random((n_faces, c))).astype(np.float32)
        jstate = ja.accumulate_view(jstate, jnp.asarray(sums), jnp.asarray(counts))
        tstate = ta.accumulate_view(tstate, torch.as_tensor(sums),
                                    torch.as_tensor(counts))
    ref = np.asarray(ja.finalize_aggregation(jstate))
    got = ta.finalize_aggregation(tstate).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, equal_nan=True)
    probe = np.nan_to_num(ref)
    probe[0] = 0.0
    np.testing.assert_array_equal(
        ta.find_argmax_nonzero_value(torch.as_tensor(probe)).numpy(),
        np.asarray(ja.find_argmax_nonzero_value(jnp.asarray(probe))),
    )
    p2f = rng.integers(-1, n_faces, (8, 9)).astype(np.int32)
    img = rng.random((8, 9, c)).astype(np.float32)
    img[0, 0, 1] = np.nan
    for t, j in zip(
        ta.project_image_to_faces(torch.as_tensor(p2f), torch.as_tensor(img), n_faces),
        ja.project_image_to_faces(jnp.asarray(p2f), jnp.asarray(img), n_faces),
    ):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)
    tex = rng.random((n_faces, c)).astype(np.float32)
    np.testing.assert_array_equal(
        ta.render_texture(torch.as_tensor(p2f), torch.as_tensor(tex)).numpy(),
        np.asarray(ja.render_texture(jnp.asarray(p2f), jnp.asarray(tex))),
    )
