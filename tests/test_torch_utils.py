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
        # a Delaunay TIN has hull slivers: an oversized tail to pack (the
        # port's own TIN, held equal to the JAX one in
        # tests/test_torch_camera_methods.py)
        verts, faces = tf.make_irregular_mesh(n_points=600, seed=3)
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
                 "EXAMPLE_INTRINSICS", "PATH_TYPE",
                 "CHUNKED_MESH_BUFFER_DIST_METERS"):
        assert getattr(tc, name) == getattr(jc, name)


# -- the port's own copies of the JAX package's host helpers ----------------


@pytest.fixture(scope="module")
def survey(tmp_path_factory):
    from geograypher_tpu.utils.example_data import create_example_survey

    return create_example_survey(tmp_path_factory.mktemp("survey"))


def test_crs_helpers_match_jax():
    from geograypher_tpu.utils import crs as jcrs
    from geograypher_tpu_torch.utils import crs as tcrs

    rng = np.random.default_rng(7)
    lla = np.stack([rng.uniform(-60, 70, 50), rng.uniform(-179, 179, 50),
                    rng.uniform(-100, 3000, 50)], axis=1)
    utm = tcrs.utm_epsg_for(36.0, -119.0)
    assert utm == jcrs.utm_epsg_for(36.0, -119.0) == 32611
    for lat, lon in lla[:, :2]:
        assert tcrs.utm_epsg_for(lat, lon) == jcrs.utm_epsg_for(lat, lon)
    site = lla[:5] * [0.01, 0.01, 1.0] + [36.0, -119.0, 0.0]
    for pts, src, dst in ((lla, 4326, 4978), (site, 4326, utm), (site, 4326, 3857)):
        out = tcrs.transform_points(pts, src, dst)
        np.testing.assert_array_equal(out, jcrs.transform_points(pts, src, dst))
        np.testing.assert_array_equal(tcrs.transform_points(out, dst, src),
                                      jcrs.transform_points(out, dst, src))


def test_metashape_parsers_match_jax(survey, tmp_path):
    import xml.etree.ElementTree as ET

    from geograypher_tpu.utils import parsing as jp
    from geograypher_tpu_torch.utils import parsing as tp

    cams = survey["cameras_file"]
    np.testing.assert_array_equal(tp.parse_transform_metashape(cams),
                                  jp.parse_transform_metashape(cams))
    sensors = ET.parse(cams).getroot().find("chunk").find("sensors")
    got, want = tp.parse_sensors(sensors), jp.parse_sensors(sensors)
    assert got == want and len(got) >= 1
    meta = tmp_path / "mesh_meta.xml"
    meta.write_text("<x><SRS>EPSG::32611</SRS><SRSOrigin>1.5,2.5,-3</SRSOrigin></x>")
    (crs_t, shift_t), (crs_j, shift_j) = (tp.parse_metashape_mesh_metadata(meta),
                                          jp.parse_metashape_mesh_metadata(meta))
    assert crs_t == crs_j and tp.crs_from_srs_text(crs_t) == jp.crs_from_srs_text(crs_j)
    np.testing.assert_array_equal(shift_t, shift_j)


def test_load_mesh_matches_jax(survey, tmp_path):
    from geograypher_tpu.utils import meshio as jm
    from geograypher_tpu_torch.utils import meshio as tm

    verts, faces, _ = jm.load_mesh(survey["mesh_file"])
    ascii_ply = tmp_path / "m.ply"
    jm.save_mesh(ascii_ply, verts, faces, binary=False)
    for path in (survey["mesh_file"], ascii_ply):
        got, want = tm.load_mesh(path), jm.load_mesh(path)
        for a, b in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(a, b)
        assert got[2].keys() == want[2].keys()
    assert len(faces) > 100


def test_lookup_segmentor_and_image_io_match_jax(survey, tmp_path):
    from geograypher_tpu.predictors.segmentors import LookUpSegmentor as JLookUp
    from geograypher_tpu.utils.io import read_image_or_numpy as jread
    from geograypher_tpu_torch.predictors.segmentors import LookUpSegmentor as TLookUp
    from geograypher_tpu_torch.utils.files import ensure_containing_folder
    from geograypher_tpu_torch.utils.io import read_image_or_numpy as tread

    n = survey["n_classes"]
    images = sorted(p for p in survey["image_folder"].iterdir())
    jseg = JLookUp(survey["image_folder"], survey["label_folder"], n)
    tseg = TLookUp(survey["image_folder"], survey["label_folder"], n)
    for img in images[:2]:
        np.testing.assert_array_equal(tread(img), jread(img))
        np.testing.assert_array_equal(tseg.segment_image(None, img),
                                      jseg.segment_image(None, img))
    # a seeded label array with out-of-range ids, served from .npy
    labels = np.random.default_rng(3).integers(-1, n + 1, (12, 10))
    base, look = tmp_path / "img", tmp_path / "lab"
    target = ensure_containing_folder(look / "a" / "v.npy")
    assert target.parent.is_dir()
    np.save(target, labels)
    fname = base / "a" / "v.JPG"
    got = TLookUp(base, look, n).segment_image(None, fname)
    np.testing.assert_array_equal(got, JLookUp(base, look, n).segment_image(None, fname))
    assert np.isnan(got[labels < 0]).all()


def test_numeric_helpers_match_jax():
    """The port's copy of utils/numeric.py: every helper equal to the JAX
    package's on the same inputs (intersection_average is held against it
    in tests/test_torch_detections.py)."""
    from geograypher_tpu.utils import numeric as jn
    from geograypher_tpu_torch.utils import numeric as tn

    rng = np.random.default_rng(0)
    for shape, frac in (((7, 12), 0.25), ((5, 5), 0.0), ((30, 3), 0.6)):
        np.testing.assert_array_equal(tn.create_ramped_weighting(shape, frac),
                                      jn.create_ramped_weighting(shape, frac))
    q = rng.normal(size=4)
    np.testing.assert_array_equal(tn.quaternion_wxyz_to_matrix(q),
                                  jn.quaternion_wxyz_to_matrix(q))
    np.testing.assert_array_equal(tn.rotation_rpy_to_matrix(10.0, -20.0, 33.0),
                                  jn.rotation_rpy_to_matrix(10.0, -20.0, 33.0))
    assert list(tn.chunk_slices(11, 4)) == list(jn.chunk_slices(11, 4))
    dist = rng.uniform(0, 1, (6, 8))
    dist[dist > 0.6] = np.nan
    dist[0, 1] = 0.0
    ids = rng.integers(0, 3, 20)
    assert (tn.format_graph_edges(slice(2, 8), slice(9, 17), dist, ids)
            == jn.format_graph_edges(slice(2, 8), slice(9, 17), dist, ids))
    pts = rng.uniform(-5, 5, (500, 2))
    np.testing.assert_array_equal(tn.hilbert_argsort_2d(pts), jn.hilbert_argsort_2d(pts))
    corners = rng.normal(size=(3, 40, 3))
    for got, want in zip(tn.compute_3D_triangle_area_vectorized(corners),
                         jn.compute_3D_triangle_area_vectorized(corners)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tn.compute_3D_triangle_area(corners, False),
                                  jn.compute_3D_triangle_area(corners, False))
    votes = rng.integers(-1, 4, (50, 7)).astype(float)
    votes[rng.random((50, 7)) < 0.2] = np.nan
    np.testing.assert_array_equal(tn.fair_mode_non_nan(votes, seed=3),
                                  jn.fair_mode_non_nan(votes, seed=3))
