"""The orthographic raster and its products against the JAX package.

``TexturedMesh.ortho_pix2face`` (a pinhole camera 40 footprints above the
mesh, tiled past ``max_pixels``) meets the knife-edge contract of
``tests/test_pallas_raster.py`` against the JAX package's on the same
mesh, untiled and tiled (>= 99% of pixels equal, face <-> face swaps
only), with the same bounds and shape.  The raster vector export and
``label_polygons`` (raster mode) are equal to the JAX package's through
the same pix2face; the exact mode is equal outright.  No capacity drop is
silent: ``rasterize_triangles`` and ``rasterize_and_count`` return their
overflow when asked and raise on it otherwise, and ``ortho_pix2face`` and
``sharded_render_aggregate`` raise on it, naming the tile or view and the
caps.
"""

import logging

import numpy as np
import pytest
import torch

from geograypher_tpu.meshes.mesh import TexturedMesh as JaxTexturedMesh
from geograypher_tpu.ops.rasterize import RasterConfig as JaxRasterConfig
from geograypher_tpu.utils.vector import Polygon as JaxPolygon
from geograypher_tpu.utils.vector import VectorData as JaxVectorData
from geograypher_tpu_torch.meshes.mesh import TexturedMesh
from geograypher_tpu_torch.ops.rasterize import (
    RasterConfig,
    rasterize_and_count,
    rasterize_triangles,
    setup_triangles,
    transform_to_camera,
)
from geograypher_tpu_torch.parallel import sharding as tsharding
from geograypher_tpu_torch.utils.fixtures import brute_force_pix2face, make_grid_mesh
from geograypher_tpu_torch.utils.vector import Polygon, VectorData
from tests.test_torch_pipeline import shard_scene
from tests.test_torch_rasterize import knife_edge, one_torch_thread  # noqa: F401

CAPS = (640, 160, 64, 32)
XLA = JaxRasterConfig(caps=CAPS, backend="xla")
RES = 0.037


@pytest.fixture(scope="module")
def scene():
    """A height field on a grid turned by 0.3 rad: the footprint's pixel
    centres fall on no family of its edges (on an axis-aligned grid whole
    diagonals of them lie on shared edges, where two float32 setups part,
    ROADMAP C4)."""
    verts, faces = make_grid_mesh(
        n=23, size=4.0, z_fn=lambda x, y: 0.15 * np.sin(3 * x) * np.cos(2 * y))
    c, s = np.cos(0.3), np.sin(0.3)
    verts = verts @ np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
    tmesh = TexturedMesh((verts, faces), raster_config=RasterConfig(caps=CAPS),
                         device="cpu")
    jmesh = JaxTexturedMesh((verts, faces), raster_config=XLA)
    cents = verts[faces].mean(axis=1)
    labels = (np.floor((cents[:, 0] + 2) * 0.9) + 2 * (cents[:, 1] > 0.3)).astype(float)
    labels[::11] = np.nan
    labels[5::13] = -1  # an unlabelled sentinel: never votes
    return tmesh, jmesh, labels


@pytest.mark.parametrize("max_pixels", [8192, 40])
def test_ortho_pix2face_matches_jax(scene, max_pixels):
    """Untiled (one 136 px tile) and 4 x 4 tiles of 34 px: the knife-edge
    contract, the same bounds, shape and CRS."""
    tmesh, jmesh, _ = scene
    got, bounds, epsg = tmesh.ortho_pix2face(resolution_m=RES, max_pixels=max_pixels)
    want, jbounds, jepsg = jmesh.ortho_pix2face(resolution_m=RES, max_pixels=max_pixels)
    assert got.shape == want.shape == (136, 136) and got.dtype == np.int32
    assert tuple(bounds) == tuple(jbounds) and epsg == jepsg is None
    knife_edge(got, want)
    assert (got >= 0).mean() > 0.6  # a turned square in its bounding box


def test_tiles_see_their_own_perspective(scene):
    """Each tile's camera stands 40 tile extents above the tile's centre
    (as the JAX package's), so tiled and untiled maps part by the
    pinhole's perspective, in both packages.  Every pasted tile is its own
    camera's render, cropped, bit for bit, and that render meets the
    knife-edge contract against the float64 oracle of the same camera."""
    tmesh, jmesh, _ = scene
    maps = {m: tmesh.ortho_pix2face(resolution_m=RES, max_pixels=m)[0] for m in (8192, 40)}
    for max_pixels, got in maps.items():
        plan = tmesh.ortho_plan(resolution_m=RES, max_pixels=max_pixels)
        tri = plan.tri.numpy().astype(np.float64)
        for i0, j0, w2c in plan.tiles:
            own = rasterize_triangles(transform_to_camera(plan.tri, w2c), plan.focal,
                                      plan.tile_w, plan.tile_h, tmesh.raster_config).numpy()
            h, w = min(plan.tile_h, plan.height - i0), min(plan.tile_w, plan.width - j0)
            np.testing.assert_array_equal(got[i0:i0 + h, j0:j0 + w], own[:h, :w])
            m = w2c.numpy().astype(np.float64)
            oracle = brute_force_pix2face(tri @ m[:3, :3].T + m[:3, 3], plan.focal,
                                          plan.tile_w, plan.tile_h)
            knife_edge(own, oracle)
    j_untiled, _, _ = jmesh.ortho_pix2face(resolution_m=RES)
    j_tiled, _, _ = jmesh.ortho_pix2face(resolution_m=RES, max_pixels=40)
    assert (maps[40] != maps[8192]).mean() > 0 and (j_tiled != j_untiled).mean() > 0


def test_ortho_total_pixels_clamp(scene, caplog):
    """Past ``max_total_pixels`` the resolution is clamped, loudly, to the
    JAX package's grid."""
    tmesh, jmesh, _ = scene
    with caplog.at_level(logging.WARNING, logger="geograypher_tpu_torch"):
        got, bounds, _ = tmesh.ortho_pix2face(resolution_m=RES, max_total_pixels=2000)
    assert "EFFECTIVE RESOLUTION DEGRADED" in caplog.text
    want, jbounds, _ = jmesh.ortho_pix2face(resolution_m=RES, max_total_pixels=2000)
    # the clamped resolution, each side rounded up: 45 x 45 px, past 2000
    assert got.shape == want.shape == (45, 45)
    np.testing.assert_allclose(bounds, jbounds, rtol=0, atol=1e-12)
    knife_edge(got, want)


@pytest.mark.parametrize("max_pixels", [8192, 40])
def test_ortho_overflow_raises(scene, max_pixels, monkeypatch):
    """Tiny caps on the mesh: the tiles' overflow is read after the last
    and raises, naming the tiles and the caps; the census sizes caps that
    hold."""
    tmesh, _, _ = scene
    roomy, _, _ = tmesh.ortho_pix2face(resolution_m=RES, max_pixels=max_pixels)
    monkeypatch.setattr(tmesh, "raster_config", RasterConfig(caps=(2, 2, 2, 2)))
    with pytest.raises(RuntimeError, match=r"ortho_pix2face: raster capacity overflow "
                       r"in tiles .* at caps \(2, 2, 2, 2\)"):
        tmesh.ortho_pix2face(resolution_m=RES, max_pixels=max_pixels)
    plan = tmesh.ortho_plan(resolution_m=RES, max_pixels=max_pixels)
    census = tmesh.ortho_raster_census(plan, RasterConfig())
    assert len(plan.tiles) == (1 if max_pixels > 136 else 16) and census[0] > 2
    tmesh.raster_config = RasterConfig(caps=tuple(census))
    exact, _, _ = tmesh.ortho_pix2face(resolution_m=RES, max_pixels=max_pixels)
    np.testing.assert_array_equal(exact, roomy)
    tmesh.raster_config = RasterConfig(caps=tuple(c - 1 if k == 0 else c
                                                  for k, c in enumerate(census)))
    with pytest.raises(RuntimeError, match="overflow"):
        tmesh.ortho_pix2face(resolution_m=RES, max_pixels=max_pixels)


def test_rasterize_triangles_returns_its_overflow(scene):
    tmesh, _, _ = scene
    plan = tmesh.ortho_plan(resolution_m=RES)
    tri = transform_to_camera(plan.tri, plan.tiles[0][2])
    full = rasterize_triangles(tri, plan.focal, plan.tile_w, plan.tile_h,
                               RasterConfig(caps=CAPS))
    p2f, overflow = rasterize_triangles(tri, plan.focal, plan.tile_w, plan.tile_h,
                                        RasterConfig(caps=CAPS), return_overflow=True)
    torch.testing.assert_close(p2f, full, rtol=0, atol=0)
    assert int(overflow) == 0 and overflow.shape == ()
    _, dropped = rasterize_triangles(tri, plan.focal, plan.tile_w, plan.tile_h,
                                     RasterConfig(caps=(2, 2, 2, 2)), return_overflow=True)
    assert int(dropped) > 0


def test_rasterizers_raise_on_an_overflow_not_asked_for(scene):
    """No drop is silent: without ``return_overflow`` a nonzero overflow of
    ``rasterize_triangles`` or ``rasterize_and_count`` raises, naming the
    dropped candidates and the caps (the JAX functions return the
    incomplete map, ROADMAP C4)."""
    tmesh, _, _ = scene
    plan = tmesh.ortho_plan(resolution_m=RES)
    tri = transform_to_camera(plan.tri, plan.tiles[0][2])
    starved = RasterConfig(caps=(2, 2, 2, 2))
    _, dropped = rasterize_triangles(tri, plan.focal, plan.tile_w, plan.tile_h, starved,
                                     return_overflow=True)
    with pytest.raises(ValueError, match=rf"rasterize_triangles: the tile lists dropped "
                       rf"{int(dropped)} candidates at caps \(2, 2, 2, 2\)"):
        rasterize_triangles(tri, plan.focal, plan.tile_w, plan.tile_h, starved)
    setup = setup_triangles(tri, plan.focal, plan.tile_w, plan.tile_h, starved.znear)
    classes = torch.zeros((plan.tile_h, plan.tile_w), dtype=torch.int32)
    n_faces = tri.shape[0]
    counts, over = rasterize_and_count(setup, classes, starved, plan.tile_h, plan.tile_w,
                                       n_faces, 1, return_overflow=True)
    assert int(over) == int(dropped) > 0
    with pytest.raises(ValueError, match=r"rasterize_and_count: the tile lists dropped"):
        rasterize_and_count(setup, classes, starved, plan.tile_h, plan.tile_w, n_faces, 1)
    roomy = RasterConfig(caps=CAPS)
    np.testing.assert_array_equal(
        rasterize_and_count(setup, classes, roomy, plan.tile_h, plan.tile_w, n_faces, 1),
        rasterize_and_count(setup, classes, roomy, plan.tile_h, plan.tile_w, n_faces, 1,
                            return_overflow=True)[0])


def test_sharded_render_aggregate_raises_on_overflow():
    """Two devices, 11 views at tiny caps: one raise after the last view,
    naming (device, view) pairs and the caps; padding views do not count."""
    tri, labels, w2c, f = shard_scene()
    mesh = tsharding.make_view_mesh(["cpu", "cpu"])
    w2c_s, f_s, valid_s = tsharding.shard_views_for_mesh(w2c, f, mesh)
    with pytest.raises(RuntimeError, match=r"raster capacity overflow in views "
                       r"\(device, view, dropped\) \[\(0, 0, \d+\).*caps \(4, 4, 4, 4\)"):
        tsharding.sharded_render_aggregate(
            tri, labels[:, None], w2c_s, f_s, valid_s, image_w=80, image_h=80,
            n_faces=len(labels), config=RasterConfig(caps=(4, 4, 4, 4)), mesh=mesh)
    # room enough: no raise (the parity with the JAX package is
    # tests/test_torch_pipeline.py's)
    tsharding.sharded_render_aggregate(
        tri, labels[:, None], w2c_s, f_s, valid_s, image_w=80, image_h=80,
        n_faces=len(labels), config=RasterConfig(caps=(256, 64, 32, 16)), mesh=mesh)


def _same_pix2face(monkeypatch, tmesh, jmesh, **kw):
    """The port's mesh given the JAX package's pix2face (for every call)."""
    want = jmesh.ortho_pix2face(**kw)
    monkeypatch.setattr(tmesh, "ortho_pix2face",
                        lambda *a, stats=None, **k: (want[0].copy(), want[1], want[2]))
    return want


def test_export_face_labels_vector_raster_matches_jax(scene, monkeypatch, tmp_path):
    """Through the same pix2face: the same polygons, ring for ring, the
    same classes and names; the file reads back."""
    tmesh, jmesh, labels = scene
    _same_pix2face(monkeypatch, tmesh, jmesh, resolution_m=RES)
    names = {0: "a", 1: "b", 2: "c"}
    got = tmesh.export_face_labels_vector(labels, label_names=names, resolution_m=RES,
                                          mode="raster", export_file=tmp_path / "v.geojson")
    want = jmesh.export_face_labels_vector(labels, label_names=names, resolution_m=RES,
                                           mode="raster")
    assert len(got) == len(want) > 3 and got.attributes == want.attributes
    assert got.epsg == want.epsg
    for g, w in zip(got.geometries, want.geometries):
        np.testing.assert_array_equal(g.exterior, w.exterior)
        assert len(g.holes) == len(w.holes)
        for gh, wh in zip(g.holes, w.holes):
            np.testing.assert_array_equal(gh, wh)
    assert len(VectorData.read_file(tmp_path / "v.geojson")) == len(want)
    with pytest.raises(ValueError, match="unknown mode"):
        tmesh.export_face_labels_vector(labels, mode="vector")


def _label_polygons_of(pkg_polygon, pkg_vector):
    rng = np.random.default_rng(3)
    polys = []
    for k in range(7):
        cx, cy = rng.uniform(-1.6, 1.6, 2)
        ang = np.sort(rng.uniform(0, 2 * np.pi, 7))
        ring = np.array([cx, cy]) + rng.uniform(0.2, 0.6, (7, 1)) * np.stack(
            [np.cos(ang), np.sin(ang)], 1)
        polys.append(pkg_polygon(ring))
    polys.append(pkg_polygon(np.array([[5.0, 5.0], [6.0, 5.0], [6.0, 6.0]])))  # off mesh
    return pkg_vector(polys, {"id": list(range(len(polys)))})


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["raster", "exact"])
def test_label_polygons_matches_jax(scene, monkeypatch, mode, weighted):
    """Class names and raw ids, with and without face weights; the raster
    mode through the same pix2face; a polygon off the mesh is unknown."""
    tmesh, jmesh, labels = scene
    if mode == "raster":
        _same_pix2face(monkeypatch, tmesh, jmesh, resolution_m=RES)
    weights = None
    if weighted:
        weights = np.where(tmesh.verts[tmesh.faces][:, :, 2].mean(axis=1) > 0, 1.0, 0.01)
    names = {c: f"class_{c}" for c in range(6)}
    tmesh.IDs_to_labels = jmesh.IDs_to_labels = names
    polys_t = _label_polygons_of(Polygon, VectorData)
    polys_j = _label_polygons_of(JaxPolygon, JaxVectorData)
    kw = dict(face_weighting=weights, resolution_m=RES, mode=mode)
    got = tmesh.label_polygons(labels, polys_t, **kw)
    want = jmesh.label_polygons(labels, polys_j, **kw)
    assert got == want and got[-1] == "unknown"
    assert len(set(got)) >= 3
    raw_t = tmesh.label_polygons(labels, polys_t, return_class_labels=False, **kw)
    raw_j = jmesh.label_polygons(labels, polys_j, return_class_labels=False, **kw)
    np.testing.assert_array_equal(raw_t, raw_j)


def test_label_polygons_on_the_port_raster_matches_jax(scene):
    """Without sharing the pix2face: the labels of polygons that cover many
    pixels agree with the JAX package's on its own raster."""
    tmesh, jmesh, labels = scene
    tmesh.IDs_to_labels = jmesh.IDs_to_labels = None
    got = tmesh.label_polygons(labels, _label_polygons_of(Polygon, VectorData),
                               resolution_m=RES)
    want = jmesh.label_polygons(labels, _label_polygons_of(JaxPolygon, JaxVectorData),
                                resolution_m=RES)
    assert got == want
