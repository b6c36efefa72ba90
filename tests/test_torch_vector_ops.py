"""The port's raster-assisted polygon operations and exact overlays against
the JAX package's (cv2 there, numpy here).

* ``utils/contours.py`` ``find_contours`` equals cv2's ``findContours``
  (``RETR_CCOMP``, ``CHAIN_APPROX_SIMPLE``, OpenCV 5.0) contour for
  contour and in its hierarchy, on seeded random masks (noise, opened and
  closed blobs, masks touching the border, empty and full) and on the
  class masks of a small orthographic render; ``ellipse_kernel``,
  ``dilate`` and ``erode`` equal cv2's exactly.
* ``utils/vector.py``: ``rasterize_polygons``, ``polygons_from_mask``,
  ``buffer_polygons`` / ``Polygon.buffer`` and ``union_all`` (raster)
  give the JAX package's rings exactly, vertex for vertex.
* ``utils/boolean_ops.py``, ``utils/exact_geometry.py``'s overlay part and
  ``utils/geospatial.py`` are numpy copies: equal outputs (areas to the
  last bit).
"""

import cv2
import numpy as np
import pytest
from scipy import ndimage

from geograypher_tpu.utils import boolean_ops as jb
from geograypher_tpu.utils import exact_geometry as je
from geograypher_tpu.utils import geospatial as jg
from geograypher_tpu.utils import vector as jv
from geograypher_tpu_torch.utils import boolean_ops as tb
from geograypher_tpu_torch.utils import contours as tc
from geograypher_tpu_torch.utils import exact_geometry as te
from geograypher_tpu_torch.utils import geospatial as tg
from geograypher_tpu_torch.utils import vector as tv
from tests.test_torch_rasterize import one_torch_thread  # noqa: F401


def _cv2_contours(mask):
    c, h = cv2.findContours(mask.astype(np.uint8), cv2.RETR_CCOMP,
                            cv2.CHAIN_APPROX_SIMPLE)
    return [a.reshape(-1, 2) for a in c], (np.zeros((0, 4), int) if h is None else h[0])


def _assert_contours_equal(mask):
    want, want_h = _cv2_contours(mask)
    got, got_h = tc.find_contours(mask)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got_h, want_h)


def _random_mask(rng, kind):
    h, w = rng.integers(1, 40, 2)
    m = rng.random((h, w)) < rng.uniform(0.05, 0.95)
    if kind == "opened":
        m = ndimage.binary_opening(m)
    elif kind == "closed":
        m = ndimage.binary_closing(m)
    elif kind == "blobs":
        f = ndimage.gaussian_filter(rng.random((h * 3, w * 3)), 2.0)
        m = f > np.median(f)
    return m


@pytest.mark.parametrize("kind", ["noise", "opened", "closed", "blobs"])
@pytest.mark.parametrize("seed", range(6))
def test_find_contours_matches_cv2(seed, kind):
    """50 masks a case: every contour (points, start, orientation) and the
    two-level hierarchy as cv2 gives them."""
    rng = np.random.default_rng(seed)
    for _ in range(50):
        _assert_contours_equal(_random_mask(rng, kind))


def test_find_contours_edge_cases():
    for m in (np.zeros((5, 7), bool), np.ones((5, 7), bool), np.ones((1, 1), bool),
              np.eye(6, dtype=bool), np.eye(6, dtype=bool)[::-1],
              np.pad(np.ones((3, 3), bool), 2)):
        _assert_contours_equal(m)
    ring = np.ones((9, 9), bool)
    ring[2:7, 2:7] = False
    ring[4, 4] = True  # an island in the hole: top level again
    _assert_contours_equal(ring)


def test_find_contours_on_ortho_class_masks(ortho_scene):
    """The class masks of a small orthographic render of a labelled mesh,
    as the raster vector export traces them."""
    p2f, labels = ortho_scene
    img = np.where(p2f >= 0, labels[np.clip(p2f, 0, None)], -1)
    for c in np.unique(img[img >= 0]):
        _assert_contours_equal(img == c)


@pytest.fixture(scope="module")
def ortho_scene():
    from geograypher_tpu.meshes.mesh import TexturedMesh as JaxTexturedMesh
    from geograypher_tpu.utils.fixtures import make_grid_mesh

    verts, faces = make_grid_mesh(n=21, size=4.0,
                                  z_fn=lambda x, y: 0.1 * np.sin(3 * x) * np.cos(3 * y))
    rng = np.random.default_rng(2)
    cents = verts[faces].mean(axis=1)
    labels = (np.floor(cents[:, 0] * 1.3 + rng.integers(0, 2, len(faces)) * 0.6)
              % 4).astype(float)
    p2f, _, _ = JaxTexturedMesh((verts, faces)).ortho_pix2face(resolution_m=0.02)
    return p2f, labels


@pytest.mark.parametrize("k", [1, 3, 4, 5, 8, 15, 31, 60])
def test_ellipse_kernel_matches_cv2(k):
    want = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (k, k)).astype(bool)
    np.testing.assert_array_equal(tc.ellipse_kernel(k), want)


@pytest.mark.parametrize("op", ["dilate", "erode"])
@pytest.mark.parametrize("k", [3, 5, 9, 21, 31])
def test_morphology_matches_cv2(op, k):
    rng = np.random.default_rng(k)
    kernel = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (k, k))
    for _ in range(10):
        h, w = rng.integers(1, 50, 2)
        m = rng.random((h, w)) < rng.uniform(0.02, 0.9)
        want = getattr(cv2, op)(m.astype(np.uint8), kernel) > 0
        got = getattr(tc, op)(m, tc.ellipse_kernel(k))
        np.testing.assert_array_equal(got, want)


def _star(rng, cx, cy, r, n=9):
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    rad = rng.uniform(0.5, 1.0, (n, 1)) * r
    return np.array([cx, cy]) + rad * np.stack([np.cos(ang), np.sin(ang)], 1)


def _polys(pkg, seed=0, n=5, holes=True):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        ext = _star(rng, 10 + 4 * (k % 3), 20 + 3 * (k // 3), 3.0)
        hs = [_star(rng, *ext.mean(axis=0), 0.6, n=5)] if holes and k % 2 else []
        out.append(pkg.Polygon(ext, hs))
    return out


def _assert_same_polygons(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.exterior, w.exterior)
        assert len(g.holes) == len(w.holes)
        for gh, wh in zip(g.holes, w.holes):
            np.testing.assert_array_equal(gh, wh)


@pytest.mark.parametrize("shape", [(64, 80), (200, 150)])
def test_rasterize_polygons_matches_jax(shape):
    """Polygons (with holes) inside the grid, later ones on top: cv2's
    fillPoly and the port's equal there (utils/polyfill.py)."""
    bounds = (5.0, 15.0, 21.0, 27.0)
    got = tv.rasterize_polygons(_polys(tv), range(1, 6), bounds, shape)
    want = jv.rasterize_polygons(_polys(jv), range(1, 6), bounds, shape)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_polygons_from_mask_matches_jax(seed):
    """Random blob masks: the same polygons, ring for ring, in the same
    order, holes under their exteriors."""
    rng = np.random.default_rng(seed)
    f = ndimage.gaussian_filter(rng.random((90, 120)), 3.0)
    mask = f > np.quantile(f, 0.45)
    bounds = (100.0, 200.0, 124.0, 218.0)
    got, want = tv.polygons_from_mask(mask, bounds), jv.polygons_from_mask(mask, bounds)
    assert any(p.holes for p in want)
    _assert_same_polygons(got, want)


@pytest.mark.parametrize("dist", [0.8, -0.4])
def test_buffer_polygons_matches_jax(dist):
    got = tv.buffer_polygons(_polys(tv, 1), dist, grid=512)
    want = jv.buffer_polygons(_polys(jv, 1), dist, grid=512)
    _assert_same_polygons(got, want)
    one_t, one_j = _polys(tv, 2, 1)[0], _polys(jv, 2, 1)[0]
    _assert_same_polygons([one_t.buffer(0.5)], [one_j.buffer(0.5)])


@pytest.mark.parametrize("method", ["raster", "exact"])
def test_union_all_matches_jax(method):
    got = tv.union_all(_polys(tv, 3), grid=400, method=method)
    want = jv.union_all(_polys(jv, 3), grid=400, method=method)
    _assert_same_polygons(got, want)


@pytest.mark.parametrize("op", ["union_exact", "intersection_exact",
                                "difference_exact", "non_overlapping_exact"])
def test_boolean_ops_match_jax(op):
    a_t, a_j = _polys(tv, 4), _polys(jv, 4)
    if op == "union_exact":
        got, want = tb.union_exact(a_t), jb.union_exact(a_j)
    elif op == "non_overlapping_exact":
        got = [p for parts in tb.non_overlapping_exact(a_t) for p in parts]
        want = [p for parts in jb.non_overlapping_exact(a_j) for p in parts]
    else:
        got = getattr(tb, op)(a_t[:2], a_t[2:])
        want = getattr(jb, op)(a_j[:2], a_j[2:])
    assert len(want) > 0
    _assert_same_polygons(got, want)


def test_exact_overlay_matches_jax():
    """ear_clip, clip_areas_convex, polygon_overlay_areas and
    polygon_intersection_area: the same triangles and areas."""
    rng = np.random.default_rng(6)
    pt, pj = _polys(tv, 5), _polys(jv, 5)
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(te.ear_clip(a.exterior), je.ear_clip(b.exterior))
    tris = rng.uniform(5, 25, (300, 3, 2))
    clip = te.ear_clip(pt[0].exterior)[0]
    np.testing.assert_array_equal(te.clip_areas_convex(tris, clip),
                                  je.clip_areas_convex(tris, clip))
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(te.polygon_overlay_areas(tris, a),
                                      je.polygon_overlay_areas(tris, b))
    for i in range(len(pt)):
        for k in range(len(pt)):
            assert te.polygon_intersection_area(pt[i], pt[k]) == \
                je.polygon_intersection_area(pj[i], pj[k])


def _vector(pkg, polys, epsg=32611, column=None):
    attrs = {} if column is None else {column: [f"c{k % 3}" for k in range(len(polys))]}
    return pkg.VectorData(polys, attrs, epsg=epsg)


@pytest.mark.parametrize("mode", ["raster", "exact"])
def test_get_overlap_vector_matches_jax(mode):
    sh = np.array([500000.0, 4000000.0])
    pt = [tv.Polygon(p.exterior + sh, [h + sh for h in p.holes]) for p in _polys(tv, 7)]
    pj = [jv.Polygon(p.exterior + sh, [h + sh for h in p.holes]) for p in _polys(jv, 7)]
    ct = [tv.Polygon(p.exterior + sh + 1.5) for p in _polys(tv, 8, holes=False)]
    cj = [jv.Polygon(p.exterior + sh + 1.5) for p in _polys(jv, 8, holes=False)]
    got, gnames = tg.get_overlap_vector(_vector(tv, pt), _vector(tv, ct, column="k"), "k",
                                        grid=256, mode=mode)
    want, wnames = jg.get_overlap_vector(_vector(jv, pj), _vector(jv, cj, column="k"), "k",
                                         grid=256, mode=mode)
    assert gnames == wnames
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 0


def test_get_overlap_raster_matches_jax(tmp_path):
    from geograypher_tpu.utils.raster import Raster, write_geotiff

    rng = np.random.default_rng(9)
    data = rng.integers(0, 4, (60, 80)).astype(np.uint8)
    data[:5] = 255
    write_geotiff(tmp_path / "c.tif", Raster(data, (0.25, 0.0, 8.0, 0.0, -0.25, 30.0), 32611))
    got = tg.get_overlap_raster(_vector(tv, _polys(tv, 10)), tmp_path / "c.tif")
    want = jg.get_overlap_raster(_vector(jv, _polys(jv, 10)), tmp_path / "c.tif")
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and want[0].sum() > 0


@pytest.mark.parametrize("method", ["exact", "raster"])
def test_ensure_non_overlapping_polygons_matches_jax(method):
    got = tg.ensure_non_overlapping_polygons(_vector(tv, _polys(tv, 11), column="k"),
                                             grid=300, method=method)
    want = jg.ensure_non_overlapping_polygons(_vector(jv, _polys(jv, 11), column="k"),
                                              grid=300, method=method)
    _assert_same_polygons(got.geometries, want.geometries)
    assert got.attributes == want.attributes and got.epsg == want.epsg
