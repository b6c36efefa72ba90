"""The port's host utilities (fixtures, face orderings, constants) against
the JAX package's: equal outputs on the same inputs."""

import numpy as np
import pytest

from geograypher_tpu import constants as jc
from geograypher_tpu.utils import fixtures as jf
from geograypher_tpu.utils import geometric as jg
from geograypher_tpu_torch import constants as tc
from geograypher_tpu_torch.utils import fixtures as tf
from geograypher_tpu_torch.utils import geometric as tg


def bumpy(x, y):
    return 0.2 * np.sin(3 * x) * np.cos(2 * y)


@pytest.mark.parametrize(
    "kwargs",
    [dict(n=5), dict(n=17, size=2.5, z_fn=bumpy, offset=(1.0, -2.0, 0.5))],
)
def test_make_grid_mesh_matches_jax(kwargs):
    for got, want in zip(tf.make_grid_mesh(**kwargs), jf.make_grid_mesh(**kwargs)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "name, args",
    [
        ("nadir_camera", (4.0, 60.0, 128)),
        ("oblique_camera", (4.0, 70.0, 128, 25.0, 30.0)),
        ("oblique_camera", (0.1, 2000.0, 3840, 60.0, 0.0)),
        ("oblique_camera", (3.0, 50.0, 80, 0.0, 0.0)),  # the nadir fallback
    ],
)
def test_cameras_match_jax(name, args):
    np.testing.assert_array_equal(getattr(tf, name)(*args), getattr(jf, name)(*args))


def test_brute_force_oracle_matches_jax():
    verts, faces = jf.make_grid_mesh(n=9, size=4.0, z_fn=bumpy)
    c2w = jf.oblique_camera(4.0, 40.0, 48, pitch_deg=20.0)
    tri = jf.gather_tri_verts(verts, faces)
    np.testing.assert_array_equal(tf.gather_tri_verts(verts, faces), tri)
    w2c = np.linalg.inv(c2w)
    tri_cam = (tri.reshape(-1, 3) @ w2c[:3, :3].T + w2c[:3, 3]).reshape(tri.shape)
    got = tf.brute_force_pix2face(tri_cam, 40.0, 48, 40)
    np.testing.assert_array_equal(got, jf.brute_force_pix2face(tri_cam, 40.0, 48, 40))
    assert (got >= 0).any() and (got < 0).any()


@pytest.mark.parametrize("mesh", ["grid", "irregular"])
@pytest.mark.parametrize("rows_per_bin", [1.0, 2.0])
def test_face_orders_match_jax(mesh, rows_per_bin):
    if mesh == "grid":
        verts, faces = jf.make_grid_mesh(n=23, size=4.0, z_fn=bumpy)
    else:
        # a Delaunay TIN has hull slivers: an oversized tail to pack
        verts, faces = jf.make_irregular_mesh(n_points=600, seed=3)
    fv = verts[faces][..., :2]
    got, n_regular = tg.partitioned_face_order(fv, rows_per_bin, return_split=True)
    want, want_regular = jg.partitioned_face_order(fv, rows_per_bin, return_split=True)
    np.testing.assert_array_equal(got, want)
    assert n_regular == want_regular
    assert (n_regular < len(faces)) == (mesh == "irregular")
    cent = fv.mean(axis=1)
    np.testing.assert_array_equal(
        tg.serpentine_face_order(cent, rows_per_bin),
        jg.serpentine_face_order(cent, rows_per_bin),
    )


def test_constants_match_jax():
    for name in ("LAT_LON_EPSG", "EARTH_CENTERED_EARTH_FIXED_EPSG",
                 "EXAMPLE_INTRINSICS", "PATH_TYPE"):
        assert getattr(tc, name) == getattr(jc, name)
