"""The port's example scripts against the JAX package's on the CPU,
detection workflows: ``colmap_detections``, ``project_detections`` and
``end_to_end_demo`` (see ``tests/test_torch_examples_aggregate.py`` for
how the scripts are run and why per-face equality is not the criterion).

Tolerances: the detection CSVs equal byte for byte; located and
triangulated points the same count, each within ``POINT_ATOL_M`` of the
JAX point; the per-face detection counts with equal per-detection totals,
the same faces observed and at most ``MAX_SWAPPED_SHARE`` of the pixels
moved between faces, the argmax equal on every face whose lead over its
runner-up is more than the pixels it swapped; masks each at least
``MIN_MASK_EQUAL`` equal; the printed lines equal (detection and face
counts among them) but where the JAX package's export or recovery is
stated otherwise below."""

import json

import numpy as np
import scipy.sparse

from tests.test_torch_examples_aggregate import (
    MAX_SWAPPED_SHARE,
    one_torch_thread,  # noqa: F401
    run_both,
    swapped_share,
)

POINT_ATOL_M = 1e-4
MIN_MASK_EQUAL = 0.99


def nearest_gaps(points, ref):
    """Each of ``points``' distance to its nearest point of ``ref``."""
    d = np.linalg.norm(np.asarray(points, float)[:, None]
                       - np.asarray(ref, float)[None], axis=-1)
    return d.min(axis=1)


def test_colmap_detections_matches_jax(tmp_path):
    (port_out, (located, objects), text), (jax_out, (jax_located, jax_objects),
                                           jax_text) = run_both("colmap_detections", tmp_path)
    np.testing.assert_array_equal(objects, jax_objects)
    assert (port_out / "preds.csv").read_bytes() == (jax_out / "preds.csv").read_bytes()
    for name in ("cameras.txt", "images.txt", "points3D.txt"):
        assert (port_out / name).read_text() == (jax_out / name).read_text()
    assert len(located) == len(jax_located) == len(objects)
    assert nearest_gaps(located, jax_located).max() <= POINT_ATOL_M
    assert nearest_gaps(located, objects).max() < 0.1  # tests/test_examples.py's bar
    assert text == jax_text


def test_project_detections_matches_jax(tmp_path):
    (port_out, n_points, text), (jax_out, jax_n_points, jax_text) = run_both(
        "project_detections", tmp_path)
    assert n_points == jax_n_points >= 2
    port_csv = (port_out / "detections.csv").read_bytes()
    assert port_csv == (jax_out / "detections.csv").read_bytes()
    counts = scipy.sparse.load_npz(port_out / "projections_to_mesh.npz").toarray()
    ref = scipy.sparse.load_npz(jax_out / "projections_to_mesh.npz").toarray()
    assert counts.shape == ref.shape
    np.testing.assert_array_equal(counts.sum(axis=0), ref.sum(axis=0))
    seen = ref.sum(axis=1) > 0
    np.testing.assert_array_equal(counts.sum(axis=1) > 0, seen)
    assert swapped_share(counts, ref) <= MAX_SWAPPED_SHARE
    # overlapping boxes of one object seen from nearby views tie closely on
    # a face: the argmax is held where the swaps cannot move it
    top2 = np.sort(ref, axis=1)[:, -2:]
    firm = seen & (top2[:, 1] - top2[:, 0] > np.abs(counts - ref).sum(axis=1))
    assert firm.sum() > 0.5 * seen.sum()
    np.testing.assert_array_equal(counts[firm].argmax(axis=1), ref[firm].argmax(axis=1))
    # the printed lines: the detections and faces equal; the exported
    # polygons follow the per-face argmax, whose near ties the swaps move
    lines, jax_lines = text.splitlines(), jax_text.splitlines()
    assert len(lines) == len(jax_lines)
    for line, jax_line in zip(lines, jax_lines):
        if "exported polygons" in line:
            assert line.split(";")[0] == jax_line.split(";")[0]
        else:
            assert line == jax_line


def _points(path):
    """(M, 3) lat, lon, altitude of a points GeoJSON, in ECEF metres."""
    from geograypher_tpu_torch.utils.crs import transform_points

    doc = json.loads(path.read_text())
    pts = [[f["geometry"]["coordinates"][1], f["geometry"]["coordinates"][0],
            f["properties"]["altitude"]] for f in doc["features"]]
    return transform_points(np.array(pts, float).reshape(-1, 3), 4326, 4978)


def test_end_to_end_demo_matches_jax(tmp_path):
    from geograypher_tpu_torch.utils.io import read_image_or_numpy

    (port_out, value, text), (jax_out, jax_value, jax_text) = run_both(
        "end_to_end_demo", tmp_path)
    assert value is None and jax_value is None
    masks = sorted(p.name for p in (port_out / "rendered_masks").glob("*.png"))
    assert masks == sorted(p.name for p in (jax_out / "rendered_masks").glob("*.png"))
    assert len(masks) >= 2  # tests/test_entrypoints.py's bar
    for name in masks:
        a = read_image_or_numpy(port_out / "rendered_masks" / name)
        b = read_image_or_numpy(jax_out / "rendered_masks" / name)
        assert a.shape == b.shape and (a == b).mean() >= MIN_MASK_EQUAL, name
    points = _points(port_out / "triangulated_points.geojson")
    ref = _points(jax_out / "triangulated_points.geojson")
    assert len(points) == len(ref) >= 1
    assert nearest_gaps(points, ref).max() <= POINT_ATOL_M
    assert text == jax_text
    overview = read_image_or_numpy(port_out / "overview.png")
    assert overview.ndim == 3 and overview.shape[2] == 3 and overview.dtype == np.uint8
