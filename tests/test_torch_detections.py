"""The detection workflow of the PyTorch port against the JAX package on
the CPU: the pairwise segment math, ray casting and clipping, the
intersection graph, the port's Louvain against networkx, communities and
``triangulate_detections`` with their cache files, sparse per-face
detection counts, the vector export and covering meshes, the detection
segmentors (the polygon fill against cv2) and both entry points on the
synthetic survey of ``tests/test_entrypoints.py``.  JAX runs its XLA
raster."""

import json
import random
import shutil

import cv2
import jax.numpy as jnp
import networkx as nx
import numpy as np
import pandas as pd
import pytest
import scipy.sparse
import torch

from geograypher_tpu.cameras.core import project_points as jax_project_points
from geograypher_tpu.cameras.segmentor_set import (
    SegmentorCameraSet as JaxSegmentorCameraSet,
)
from geograypher_tpu.entrypoints.multiview_detections import (
    multiview_detections as jax_multiview_detections,
)
from geograypher_tpu.entrypoints.project_detections import (
    project_detections as jax_project_detections,
)
from geograypher_tpu.meshes import sparse as jsparse
from geograypher_tpu.ops import raycast as jraycast
from geograypher_tpu.ops import triangulate as jtri
from geograypher_tpu.predictors import segmentors as jseg
from geograypher_tpu.utils.example_data import create_example_survey
from geograypher_tpu.utils.vector import Polygon as JaxPolygon
from geograypher_tpu.utils.vector import VectorData as JaxVectorData
from geograypher_tpu_torch import interop
from geograypher_tpu_torch.cameras import core as tcore
from geograypher_tpu_torch.cameras.segmentor_set import SegmentorCameraSet
from geograypher_tpu_torch.entrypoints.multiview_detections import (
    multiview_detections,
)
from geograypher_tpu_torch.entrypoints.project_detections import project_detections
from geograypher_tpu_torch.meshes import sparse as tsparse
from geograypher_tpu_torch.ops import raycast as traycast
from geograypher_tpu_torch.ops import triangulate as ttri
from geograypher_tpu_torch.predictors import segmentors as tseg
from geograypher_tpu_torch.utils.louvain import Graph, louvain_communities
from geograypher_tpu_torch.utils.polyfill import fill_poly
from geograypher_tpu_torch.utils.vector import VectorData
from tests.test_integration_extra import make_scene
from tests.test_torch_rasterize import knife_edge, one_torch_thread  # noqa: F401

# points and distances of the pairwise math: float32 on both sides,
# XLA contracting multiply-adds into FMAs where torch does not
ATOL = 1e-5
T_RTOL = 1e-5  # ray parameters
POINT_ATOL = 1e-4  # triangulated points, local units
DEG_ATOL = 1e-7  # exported lon/lat points, degrees

SEGMENT_CASES = {
    "crossing": ((-1, 0, 0), (1, 0, 0), (0, -1, 1), (0, 1, 1)),
    "skew": ((0, 0, 0), (1, 0, 0), (2, 0, 1), (2, 1, 1)),
    "parallel_before": ((2, 0, 0), (3, 0, 0), (-2, 1, 0), (-1, 1, 0)),
    "parallel_after": ((0, 0, 0), (1, 0, 0), (3, 1, 0), (4, 1, 0)),
    "overlapping": ((0, 0, 0), (2, 0, 0), (1, 1, 0), (3, 1, 0)),
}


def both_pairwise(a0, a1, b0, b1, clamp):
    ours = ttri.pairwise_segment_closest_points(a0, a1, b0, b1, clamp=clamp,
                                                device="cpu")
    theirs = jtri.pairwise_segment_closest_points(a0, a1, b0, b1, clamp=clamp)
    return ours, theirs


@pytest.mark.parametrize("clamp", [True, False])
@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_pairwise_segments_match_jax(case, clamp):
    """The five analytic cases of tests/test_triangulate.py, both ways
    round and against each other, clamped and not."""
    segs = np.asarray(SEGMENT_CASES[case], dtype=float)
    a0, a1 = segs[[0, 2]], segs[[1, 3]]
    ours, theirs = both_pairwise(a0, a1, a0, a1, clamp)
    for x, y in zip(ours, theirs):
        assert x.dtype == np.float32
        np.testing.assert_allclose(x, np.asarray(y), atol=ATOL, rtol=0)


@pytest.mark.parametrize("clamp", [True, False])
def test_pairwise_random_segments_match_jax(clamp):
    """Random segments at a 50 m scene scale: atol 1e-5 x the scale."""
    rng = np.random.default_rng(0)
    scale = 50.0
    a0 = rng.uniform(-1, 1, (37, 3)) * scale
    a1 = a0 + rng.normal(size=(37, 3)) * scale / 4
    b0 = rng.uniform(-1, 1, (23, 3)) * scale
    b1 = b0 + rng.normal(size=(23, 3)) * scale / 4
    ours, theirs = both_pairwise(a0, a1, b0, b1, clamp)
    for x, y in zip(ours, theirs):
        np.testing.assert_allclose(x, np.asarray(y), atol=ATOL * scale, rtol=0)
    # an alias under the reference's name
    assert ttri.compute_approximate_ray_intersections is (
        ttri.pairwise_segment_closest_points)


def grid_covering(n=8, z=2.0):
    """An n x n covering grid on integer coordinates 0..n-1 at height z
    (every product of the ray math exact in float32)."""
    verts = np.stack(np.meshgrid(np.arange(n), np.arange(n), indexing="xy"),
                     -1).reshape(-1, 2).astype(float)
    verts = np.concatenate([verts, np.full((len(verts), 1), z)], 1)
    iy, ix = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    v00 = (iy * n + ix).ravel()
    faces = np.concatenate([np.stack([v00, v00 + 1, v00 + n + 1], 1),
                            np.stack([v00, v00 + n + 1, v00 + n], 1)],
                           1).reshape(-1, 3)
    return verts, faces


def test_ray_triangle_intersect_matches_jax():
    """Vertical rays through grid vertices, edge midpoints and cell
    centres of a covering grid (ties between faces sharing an edge go to
    the lowest id in both), and slanted rays over a bumpy grid: t to
    rtol 1e-5, face ids equal; the result at two chunk sizes equal."""
    verts, faces = grid_covering()
    tri = verts[faces]
    xs = np.arange(0.0, 7.5, 0.5)
    xy = np.stack(np.meshgrid(xs, xs), -1).reshape(-1, 2)
    origins = np.concatenate([xy, np.full((len(xy), 1), 10.0)], 1)
    dirs = np.tile([0.0, 0.0, -1.0], (len(xy), 1))
    rng = np.random.default_rng(1)
    bumpy = tri.copy()
    bumpy[..., 2] += 0.3 * np.sin(bumpy[..., 0]) * np.cos(bumpy[..., 1])
    slanted_o = np.concatenate([rng.uniform(0.5, 6.5, (200, 2)),
                                rng.uniform(5, 10, (200, 1))], 1)
    slanted_d = np.concatenate([rng.normal(0, 0.3, (200, 2)),
                                -np.ones((200, 1))], 1)
    for o, d, t3, min_hit in ((origins, dirs, tri, 1.0),
                              (slanted_o, slanted_d, bumpy, 0.5)):
        jt, jf = (np.asarray(x) for x in jraycast.ray_triangle_intersect(
            jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32),
            jnp.asarray(t3, jnp.float32)))
        args = [torch.as_tensor(x, dtype=torch.float32) for x in (o, d, t3)]
        tt, tf = traycast.ray_triangle_intersect(*args)
        tt2, tf2 = traycast.ray_triangle_intersect(*args, max_pairs=len(t3) * 7)
        assert torch.equal(tt, tt2) and torch.equal(tf, tf2)
        tt, tf = tt.numpy(), tf.numpy()
        assert tf.dtype == np.int32
        np.testing.assert_array_equal(tf, jf)
        hit = np.isfinite(jt)
        # every vertical ray hits, through shared edges and vertices too
        assert hit.sum() >= min_hit * len(o)
        np.testing.assert_array_equal(np.isfinite(tt), hit)
        np.testing.assert_allclose(tt[hit], jt[hit], rtol=T_RTOL, atol=0)


def test_clip_line_segments_matches_jax():
    verts, faces = grid_covering()
    ceiling = verts[faces] + [0.0, 0.0, 3.0]
    floor = verts[faces] - [0.0, 0.0, 1.0]
    rng = np.random.default_rng(2)
    starts = np.concatenate([rng.uniform(-2, 9, (300, 2)),
                             np.full((300, 1), 12.0)], 1)
    ends = starts + np.concatenate([rng.normal(0, 2, (300, 2)),
                                    np.full((300, 1), -20.0)], 1)
    ours = traycast.clip_line_segments(starts, ends, ceiling, floor, device="cpu")
    theirs = jraycast.clip_line_segments(starts, ends, ceiling, floor)
    valid = np.asarray(theirs[2])
    np.testing.assert_array_equal(ours[2], valid)
    assert 0 < valid.sum() < len(valid)
    for x, y in zip(ours[:2], theirs[:2]):
        np.testing.assert_allclose(x[valid], np.asarray(y)[valid], rtol=T_RTOL,
                                   atol=ATOL)


def ray_bundles(n_points=6, rays_each=5, seed=3, spread=0.02):
    """Rays from 'images' converging near a few points, each image seeing
    every point: (starts, ends, ray_IDs)."""
    rng = np.random.default_rng(seed)
    points = rng.uniform(-10, 10, (n_points, 3))
    starts, ends, ids = [], [], []
    for k in range(rays_each):
        cam = np.array([rng.uniform(-20, 20), rng.uniform(-20, 20), 30.0])
        for p in points:
            target = p + rng.normal(0, spread, 3)
            d = (target - cam) / np.linalg.norm(target - cam)
            starts.append(cam)
            ends.append(cam + 60.0 * d)
            ids.append(k)
    return np.asarray(starts), np.asarray(ends), np.asarray(ids)


def edge_margin(starts, ends, threshold):
    """The least |distance - threshold| over all pairs (JAX's distances)."""
    _, _, d = jtri.pairwise_segment_closest_points(starts, ends, starts, ends,
                                                   clamp=True)
    return np.abs(np.asarray(d, np.float64) - threshold).min()


def separated_rays(n_points=4, views=5, gap=0.1):
    """Unit-scale segments through points 2 units apart, one a view per
    point: view k's segment comes down at 45 deg from azimuth 72 k deg
    and passes ``gap * k`` above the point, so two views' segments at
    one point pass ~0.06 or more apart, and those of different points
    far apart."""
    points = np.array([[2.0 * (j - (n_points - 1) / 2), 0.3 * (-1.0) ** j, 0.2 * j]
                       for j in range(n_points)])
    starts, ends, ids = [], [], []
    for k in range(views):
        az = np.deg2rad(72.0 * k)
        d = np.array([np.cos(az), np.sin(az), -1.0]) / np.sqrt(2.0)
        for p in points:
            q = p + [0.0, 0.0, gap * k]
            starts.append(q - d)
            ends.append(q + d)
            ids.append(k)
    return np.asarray(starts), np.asarray(ends), np.asarray(ids)


def both_graphs(starts, ends, ids, threshold, **kwargs):
    theirs = jtri.calc_graph_weights(starts, ends, ids, threshold, **kwargs)
    ours = ttri.calc_graph_weights(starts, ends, ids, threshold, device="cpu",
                                   **kwargs)
    assert [(i, j) for i, j, _ in ours] == [(i, j) for i, j, _ in theirs]
    return (np.array([w["weight"] for *_, w in ours]),
            np.array([w["weight"] for *_, w in theirs]))


@pytest.mark.parametrize("step", [5000, 7])
def test_graph_weights_match_jax(step):
    """An equal edge list (pairs and order) with weights to rtol 1e-5, on
    a unit-scale scene with no distance within 1e-4 of the threshold and
    none under 0.05 (a weight is 1 / distance: float32 rounding of the
    inputs, ~1e-7 at this scale, moves it by 1e-5 at a distance of 0.01;
    the scene reads 1.2e-6 at most); blocks of 7 rays
    exercise the upper-triangular block walk.  On converging bundles with
    pairs far closer, the distances (1 / weight) agree to 1e-5 x the
    scene's scale."""
    starts, ends, ids = separated_rays()
    threshold = 0.5
    assert edge_margin(starts, ends, threshold) > 1e-4
    stats = {}
    ttri.calc_graph_weights(starts, ends, ids, threshold, step=step,
                            device="cpu", stats=stats)
    assert set(stats) == {"blocks_device_s", "format_s"}
    ours, theirs = both_graphs(starts, ends, ids, threshold, step=step)
    assert len(theirs) >= 4 * 10 and 1 / theirs.max() > 0.05
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=0)
    edges = ttri.calc_graph_weights(starts, ends, ids, threshold, step=step,
                                    device="cpu")
    assert all(isinstance(i, int) and isinstance(w["weight"], float)
               for i, _, w in edges)
    # converging bundles at a 10 m scale, pairs down to ~1e-3 apart
    starts, ends, ids = ray_bundles()
    threshold = 0.3
    assert edge_margin(starts, ends, threshold) > 1e-4
    ours, theirs = both_graphs(starts, ends, ids, threshold, step=step)
    assert len(theirs) > 20
    np.testing.assert_allclose(1 / ours, 1 / theirs, atol=ATOL * 10, rtol=0)
    # a transform receives the whole float64 block, as in the JAX package
    seen = []

    def transform(d):
        seen.append(d.dtype)
        return d * 2.0

    ours, theirs = both_graphs(starts, ends, ids, threshold, step=step,
                               transform=transform)
    assert set(seen) == {np.dtype(np.float64)}
    np.testing.assert_allclose(1 / ours, 1 / theirs, atol=ATOL * 20, rtol=0)


def random_graph(seed, n=40, p=0.12, parts=1):
    rng = np.random.default_rng(seed)
    edges = []
    for c in range(parts):
        for i in range(n):
            for j in range(i + 1, n):
                if rng.random() < p:
                    edges.append((c * n + i, c * n + j,
                                  {"weight": float(rng.exponential(1.0))}))
    return [edges[k] for k in rng.permutation(len(edges))]


@pytest.mark.parametrize("resolution", [0.5, 1.0, 2.0])
@pytest.mark.parametrize("graph_seed,parts", [(0, 1), (1, 1), (2, 3)],
                         ids=["random0", "random1", "three_parts"])
def test_louvain_equals_networkx(graph_seed, parts, resolution):
    """networkx's partitions, list for list and set for set (and in the
    same set iteration order), for seeds 0-4."""
    edges = random_graph(graph_seed, parts=parts)
    for seed in range(5):
        want = nx.community.louvain_communities(
            nx.Graph(edges), weight="weight", resolution=resolution, seed=seed)
        got = louvain_communities(Graph(edges), resolution=resolution, seed=seed)
        assert got == want
        assert [list(s) for s in got] == [list(s) for s in want]
    # a seeded random.Random is taken as it is
    rnd_a, rnd_b = random.Random(7), random.Random(7)
    assert louvain_communities(Graph(edges), seed=rnd_a) == (
        nx.community.louvain_communities(nx.Graph(edges), seed=rnd_b))


def test_louvain_graph_orders_nodes_as_networkx():
    edges = random_graph(4, n=12, p=0.4)
    g, want = Graph(edges), nx.Graph(edges)
    assert list(g.nodes) == list(want.nodes)
    assert [(u, v) for u, v, _ in g.edges()] == list(want.edges())
    assert [g.degree(n) for n in g.nodes] == [
        d for _, d in want.degree(weight="weight")]
    assert louvain_communities(Graph([]), seed=0) == []


def test_communities_match_jax():
    """Equal ray communities and their points (atol 1e-4) on converging
    bundles, with and without a local -> ECEF transform."""
    starts, ends, ids = ray_bundles(seed=5)
    edges = jtri.calc_graph_weights(starts, ends, ids, 0.3)
    from geograypher_tpu.utils.example_data import local_to_ecef_frame

    for transform in (None, local_to_ecef_frame(36.0, -119.0)):
        want = jtri.calc_communities(starts, ends, edges, seed=0,
                                     transform_to_epsg_4978=transform)
        stats = {}
        got = ttri.calc_communities(starts, ends, edges, seed=0, device="cpu",
                                    transform_to_epsg_4978=transform, stats=stats)
        assert sorted(got) == sorted(want)
        np.testing.assert_array_equal(got["ray_IDs"], want["ray_IDs"])
        np.testing.assert_allclose(got["community_points"],
                                   want["community_points"], atol=POINT_ATOL)
        if transform is not None:
            np.testing.assert_allclose(got["community_points_latlon"][:, :2],
                                       want["community_points_latlon"][:, :2],
                                       atol=DEG_ATOL, rtol=0)
        assert set(stats) == {"louvain_s", "average_s"}
    assert len(want["community_points"]) == 6
    empty = ttri.calc_communities(starts, ends, [], device="cpu",
                                  transform_to_epsg_4978=transform)
    want = jtri.calc_communities(starts, ends, [], transform_to_epsg_4978=transform)
    assert {k: v.shape for k, v in empty.items()} == {
        k: v.shape for k, v in want.items()}


def test_lstsq_and_intersection_average_match_jax():
    from geograypher_tpu.utils.numeric import intersection_average as jax_avg
    from geograypher_tpu_torch.utils.numeric import intersection_average

    starts, ends, _ = ray_bundles(n_points=1, rays_each=6)
    np.testing.assert_allclose(intersection_average(starts, ends, device="cpu"),
                               jax_avg(starts, ends), atol=POINT_ATOL)
    np.testing.assert_array_equal(
        ttri.triangulate_rays_lstsq(starts, ends - starts),
        jtri.triangulate_rays_lstsq(starts, ends - starts))


class MockDetector:
    """Two detections per image at fixed pixels
    (tests/test_integration_extra.py)."""

    def get_detection_centers(self, filename):
        return np.array([[30.0, 30.0], [50.0, 55.0]])


TRIANGULATION_MATRIX = [
    dict(),
    dict(limit_angle_from_vert=1.2),
    dict(boundaries=True),
    dict(boundaries=True, limit_ray_length_meters=50.0),
    dict(louvain_resolution=2.0),
    dict(similarity_threshold_meters=1.0),
]


def exactly_parallel(starts, ends):
    """(N, N) pairs whose float32 unit directions have a cross product of
    exactly 0 in the port, which takes the parallel cases there.  XLA
    contracts the JAX package's cross product into FMAs, which leaves
    ~1e-17 for equal directions, so it takes the skew formulas for them
    (ROADMAP C4)."""
    a = (torch.as_tensor(ends, dtype=torch.float32)
         - torch.as_tensor(starts, dtype=torch.float32))
    u = a / ttri._norm(a)[:, None]
    c = ttri._cross(u[:, None], u[None])
    return (ttri._dot(c, c) == 0).numpy() & ~np.eye(len(a), dtype=bool)


def read_cache(folder):
    seg = dict(np.load(folder / "line_segments.npz"))
    edges = json.loads((folder / "edge_weights.json").read_text())
    comm = dict(np.load(folder / "communities.npz"))
    return seg, edges, comm


@pytest.mark.parametrize("kwargs", TRIANGULATION_MATRIX,
                         ids=lambda k: "-".join(k) or "defaults")
def test_triangulate_detections_matches_jax(kwargs, tmp_path):
    """The kwargs matrix of test_triangulation_smoke_matrix: the three
    cache files of both packages agree (segments atol 1e-5, the same
    edges, equal communities, points atol 1e-4), and each package resumes
    from the other's files to its own points."""
    jmesh, jcams = make_scene(n=9, n_cams=4)
    tcams = interop.cameras_from_jax(jcams)
    kwargs = dict(kwargs)
    if kwargs.pop("boundaries", False):
        tmesh = interop.mesh_from_jax(jmesh, device="cpu")
        jb = jmesh.export_covering_meshes(N=8, z_buffer=(3.0, -1.0))
        tb = tmesh.export_covering_meshes(N=8, z_buffer=(3.0, -1.0))
        for (jv, jf), (tv, tf) in zip(jb, tb):
            np.testing.assert_array_equal(tv, jv)
            np.testing.assert_array_equal(tf, jf)
        kwargs["boundaries"] = tb
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    want = jcams.triangulate_detections(MockDetector(), ray_length_meters=20.0,
                                        out_dir=jdir, **kwargs)
    stats = {}
    got = tcams.triangulate_detections(MockDetector(), ray_length_meters=20.0,
                                       out_dir=tdir, device="cpu", stats=stats,
                                       **kwargs)
    assert got.ndim == 2 and got.shape[1] == 3 and got.shape == want.shape
    assert {"rays_s", "clip_s", "blocks_device_s", "louvain_s"} <= set(stats)
    (jseg_, jedges, jcomm), (tseg_, tedges, tcomm) = read_cache(jdir), read_cache(tdir)
    np.testing.assert_array_equal(tseg_["ray_IDs"], jseg_["ray_IDs"])
    for key in ("ray_starts", "ray_ends"):
        assert tseg_[key].dtype == jseg_[key].dtype
        np.testing.assert_allclose(tseg_[key], jseg_[key], atol=ATOL * 20)
    assert [e[:2] for e in tedges] == [e[:2] for e in jedges]
    np.testing.assert_allclose([e[2]["weight"] for e in tedges],
                               [e[2]["weight"] for e in jedges], rtol=1e-5)
    np.testing.assert_array_equal(tcomm["ray_IDs"], jcomm["ray_IDs"])
    # the points of communities without an exactly parallel pair agree;
    # the scene's cameras share one rotation, so rays through one pixel
    # of two views are exactly parallel (joined at threshold 1 m)
    parallel = exactly_parallel(tseg_["ray_starts"], tseg_["ray_ends"])
    for c in range(len(got)):
        idx = np.nonzero(tcomm["ray_IDs"] == c)[0]
        if not parallel[np.ix_(idx, idx)].any():
            np.testing.assert_allclose(got[c], want[c], atol=POINT_ATOL)
        else:
            assert kwargs == {"similarity_threshold_meters": 1.0}
    # each resumes from the other's files, returning its reader's points
    cross_t, cross_j = tmp_path / "t_from_j", tmp_path / "j_from_t"
    shutil.copytree(jdir, cross_t)
    shutil.copytree(tdir, cross_j)
    np.testing.assert_array_equal(
        tcams.triangulate_detections(MockDetector(), ray_length_meters=20.0,
                                     out_dir=cross_t, device="cpu", **kwargs),
        want)
    np.testing.assert_array_equal(
        jcams.triangulate_detections(MockDetector(), ray_length_meters=20.0,
                                     out_dir=cross_j, **kwargs),
        got)


def test_triangulate_without_detections_or_card():
    class Empty:
        def get_detection_centers(self, filename):
            return np.zeros((0, 2))

    jmesh, jcams = make_scene(n=5, n_cams=2)
    tcams = interop.cameras_from_jax(jcams)
    pts = tcams.triangulate_detections(Empty(), ray_length_meters=10.0,
                                       device="cpu")
    assert pts.shape == jcams.triangulate_detections(
        Empty(), ray_length_meters=10.0).shape == (0, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcams.triangulate_detections(Empty(), ray_length_meters=10.0)


def test_project_points_and_pixel_rays_match_jax():
    """Batched projection and rays (the full principal point) against
    the JAX package's, to float32 rounding."""
    jmesh, jcams = make_scene(n=9, n_cams=3)
    for s in jcams.sensors.values():
        s["cx"], s["cy"] = 1.5, -2.0
    jcams._batch_cache = {}
    tcams = interop.cameras_from_jax(jcams)
    jb, tb = jcams.get_camera_batch(), tcams.get_camera_batch(device="cpu")
    pts = np.random.default_rng(0).uniform(-2, 2, (50, 3))
    theirs = jax_project_points(jb, jnp.asarray(pts, jnp.float32))
    ours = tcore.project_points(tb, torch.as_tensor(pts, dtype=torch.float32))
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(theirs[0]), atol=1e-3)
    np.testing.assert_allclose(ours[1].numpy(), np.asarray(theirs[1]), rtol=1e-6)
    np.testing.assert_array_equal(ours[2].numpy(), np.asarray(theirs[2]))
    from geograypher_tpu.cameras.core import pixel_rays as jax_pixel_rays

    ij = np.random.default_rng(1).uniform(0, 80, (3, 7, 2))
    theirs = jax_pixel_rays(jb, jnp.asarray(ij, jnp.float32), line_length=20.0)
    ours = tcore.pixel_rays(tb, torch.as_tensor(ij, dtype=torch.float32), 20.0)
    for x, y in zip(ours, theirs):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-5)
    assert tcams.get_local_scale() == jcams.get_local_scale()


# -- sparse per-face detection counts ------------------------------------------


def box_table(tmp_path, names, rng, n_per_image=3, size=80):
    """A DeepForest-style CSV of seeded boxes; returns its path."""
    rows = []
    for name in names:
        for _ in range(n_per_image):
            x0, y0 = rng.integers(-5, size - 10, 2)
            w, h = rng.integers(4, 30, 2)
            rows.append(dict(image_path=f"some/dir/{name}", xmin=int(x0),
                             ymin=int(y0), xmax=int(x0 + w), ymax=int(y0 + h),
                             label=f"tree_{rng.integers(0, 3)}",
                             score=float(rng.uniform())))
    path = tmp_path / "boxes.csv"
    pd.DataFrame(rows).to_csv(path, index=False)
    return path


def csr_equal(a, b):
    a, b = a.tocsr(), b.tocsr()
    a.sort_indices()
    b.sort_indices()
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


def sparse_scenes(tmp_path, segmentor):
    """Three nadir views of a bumpy grid, their centres off the pixel
    grid's symmetry (no pixel centre on a shared edge), with detection
    boxes from a CSV or image ids."""
    from geograypher_tpu.cameras.core import CameraSet as JaxCameraSet
    from geograypher_tpu.meshes.mesh import TexturedMesh as JaxTexturedMesh
    from geograypher_tpu.ops.rasterize import RasterConfig as JaxRasterConfig
    from geograypher_tpu.utils.fixtures import make_grid_mesh, nadir_camera

    verts, faces = make_grid_mesh(n=9, size=4.0, z_fn=lambda x, y: 0.1 * np.sin(
        3 * x) * np.cos(2 * y))
    jmesh = JaxTexturedMesh((verts, faces),
                            raster_config=JaxRasterConfig(caps=(512, 64, 32, 16)))
    c2ws = []
    for k in range(3):
        c2w = nadir_camera(4.0, 40.0, 80)
        c2w[:3, 3] += (0.3 * k + 0.013, -0.021, 0.0)
        c2ws.append(c2w)
    names = [f"img_{k}.png" for k in range(3)]
    jcams = JaxCameraSet(c2ws, {0: {"f": 40.0, "cx": 0.0, "cy": 0.0,
                                    "image_width": 80, "image_height": 80}},
                         image_filenames=[tmp_path / n for n in names])
    if segmentor == "tabular":
        path = box_table(tmp_path, names, np.random.default_rng(0))
        jdet = jseg.TabularRectangleSegmentor(path, image_shape=(80, 80))
        tdet = tseg.TabularRectangleSegmentor(path, image_shape=(80, 80))
    else:
        jdet = jseg.ImageIDSegmentor((80, 80), 3)
        tdet = tseg.ImageIDSegmentor((80, 80), 3)
    tmesh = interop.mesh_from_jax(jmesh, device="cpu")
    tcams = interop.cameras_from_jax(jcams)
    return (jmesh, JaxSegmentorCameraSet(jcams, jdet), tmesh,
            SegmentorCameraSet(tcams, tdet), jdet.num_classes)


@pytest.mark.parametrize("segmentor", ["tabular", "image_id"])
def test_aggregate_index_predictions_matches_jax(segmentor, tmp_path):
    """The CSR and the views per face equal to the JAX package's (the two
    rasters agree on every pixel of this scene, which the test checks);
    normalisation and the argmax on it equal too."""
    jmesh, jseg_cams, tmesh, tseg_cams, n = sparse_scenes(tmp_path, segmentor)
    for i in range(3):
        np.testing.assert_array_equal(
            tmesh.pix2face(tseg_cams, [i])[0], jmesh.pix2face(jseg_cams, [i])[0])
    want, want_seen = jsparse.aggregate_index_predictions(jmesh, jseg_cams, n)
    stats = []
    got, seen = tsparse.aggregate_index_predictions(tmesh, tseg_cams, n,
                                                    stats=stats)
    assert got.nnz > 0 and len(stats) == 3
    csr_equal(got, want)
    np.testing.assert_array_equal(seen, want_seen)
    for faces_seen in (None, seen):
        csr_equal(tsparse.normalize_sparse_counts(got, faces_seen),
                  jsparse.normalize_sparse_counts(want, faces_seen))
    np.testing.assert_array_equal(tsparse.sparse_argmax(got),
                                  jsparse.sparse_argmax(want))


def test_sparse_counts_through_the_same_pix2face(tmp_path):
    """A scene where the port's float32 setup and XLA's round apart on
    shared edges (ROADMAP C4): pix2face meets the knife-edge contract,
    and the port's counts through JAX's pix2face equal JAX's exactly."""
    from geograypher_tpu.cameras.core import CameraSet as JaxCameraSet
    from geograypher_tpu.meshes.mesh import TexturedMesh as JaxTexturedMesh
    from geograypher_tpu.ops.rasterize import RasterConfig as JaxRasterConfig
    from geograypher_tpu.utils.fixtures import make_grid_mesh, oblique_camera

    verts, faces = make_grid_mesh(n=41, size=4.0, z_fn=lambda x, y: 0.2 * np.sin(
        3 * x) * np.cos(2 * y))
    jmesh = JaxTexturedMesh((verts, faces),
                            raster_config=JaxRasterConfig(caps=(512, 128, 64, 64)))
    c2ws = [oblique_camera(4.0, 90.0, 160, pitch_deg=p, azimuth_deg=a)
            for p, a in ((25.0, 30.0), (35.0, 200.0))]
    jcams = JaxCameraSet(c2ws, {0: {"f": 90.0, "cx": 0.0, "cy": 0.0,
                                    "image_width": 160, "image_height": 120}})
    jdet = jseg.ImageIDSegmentor((120, 160), 2)
    jseg_cams = JaxSegmentorCameraSet(jcams, jdet)
    tmesh = interop.mesh_from_jax(jmesh, device="cpu")
    tseg_cams = SegmentorCameraSet(interop.cameras_from_jax(jcams),
                                   tseg.ImageIDSegmentor((120, 160), 2))
    jp2f = jmesh.pix2face(jseg_cams)
    tp2f = tmesh.pix2face(tseg_cams)
    for a, b in zip(tp2f, jp2f):
        knife_edge(a, b)
    want, want_seen = jsparse.aggregate_index_predictions(jmesh, jseg_cams, 2)

    def jax_raster(cameras, index, **kw):
        return torch.as_tensor(jp2f[index])

    tmesh._pix2face_device = jax_raster
    got, seen = tsparse.aggregate_index_predictions(tmesh, tseg_cams, 2)
    csr_equal(got, want)
    np.testing.assert_array_equal(seen, want_seen)


def test_sparse_counts_refuse_int32_overflow(tmp_path, monkeypatch):
    jmesh, jseg_cams, tmesh, tseg_cams, n = sparse_scenes(tmp_path, "image_id")
    monkeypatch.setattr(type(tmesh), "n_faces", property(lambda self: 2**31))
    with pytest.raises(ValueError, match="overflows the int32"):
        tsparse.aggregate_index_predictions(tmesh, tseg_cams, n)


def test_local_class_image_is_the_host_remap():
    rng = np.random.default_rng(0)
    img = np.where(rng.random((30, 40)) < 0.4, np.nan,
                   rng.choice([3.0, 17.0, 17.5, 250.0], (30, 40)))
    local, classes = tsparse.local_class_image(torch.as_tensor(img))
    finite = np.isfinite(img)
    want_classes = np.unique(img[finite]).astype(np.int64)
    want = np.full(img.shape, -1, np.int32)
    want[finite] = np.searchsorted(want_classes, img[finite].astype(np.int64))
    np.testing.assert_array_equal(classes.numpy(), want_classes)
    np.testing.assert_array_equal(local.numpy(), want)


# -- vector export, covering meshes, segmentors ---------------------------------


def test_export_face_labels_vector_matches_jax(tmp_path):
    """Exact class regions of a labelled, georeferenced mesh: the same
    polygons (every ring vertex equal), classes, names and CRS; the raster
    mode (ported since A6) gives the JAX package's polygons through the
    same orthographic pix2face."""
    survey = create_example_survey(tmp_path / "s", n_cameras=1,
                                   write_label_images=False)
    from geograypher_tpu.meshes.mesh import TexturedMesh as JaxTexturedMesh
    from geograypher_tpu_torch.meshes.mesh import TexturedMesh

    jmesh = JaxTexturedMesh(survey["mesh_file"],
                            transform_filename=survey["cameras_file"])
    tmesh = TexturedMesh(survey["mesh_file"],
                         transform_filename=survey["cameras_file"], device="cpu")
    labels = np.asarray(survey["face_labels"], float)
    labels[::7] = np.nan
    names = {0: "ground", 1: "tree", 2: "shrub"}
    want = jmesh.export_face_labels_vector(labels, label_names=names)
    got = tmesh.export_face_labels_vector(labels, label_names=names,
                                          export_file=tmp_path / "v.geojson")
    assert got.epsg == want.epsg and len(got) == len(want) > 1
    assert got.attributes == want.attributes
    for g, w in zip(got.geometries, want.geometries):
        np.testing.assert_array_equal(g.exterior, w.exterior)
        assert len(g.holes) == len(w.holes)
        for gh, wh in zip(g.holes, w.holes):
            np.testing.assert_array_equal(gh, wh)
    assert len(VectorData.read_file(tmp_path / "v.geojson")) == len(want)
    ortho = jmesh.ortho_pix2face(resolution_m=0.25)
    tmesh.ortho_pix2face = lambda *a, stats=None, **k: (ortho[0].copy(), *ortho[1:])
    raster = tmesh.export_face_labels_vector(labels, label_names=names,
                                             resolution_m=0.25, mode="raster")
    jraster = jmesh.export_face_labels_vector(labels, label_names=names,
                                              resolution_m=0.25, mode="raster")
    assert len(raster) == len(jraster) > 1 and raster.attributes == jraster.attributes
    assert raster.epsg == jraster.epsg == want.epsg
    for g, w in zip(raster.geometries, jraster.geometries):
        np.testing.assert_array_equal(g.exterior, w.exterior)
        assert len(g.holes) == len(w.holes)


def test_aggregate_images_writes_the_top_down_vector(survey, tmp_path):
    """``aggregate_images`` exports its predicted classes as the exact
    polygons of ``export_face_labels_vector``, which the JAX package's
    mesh gives for the same classes too."""
    from geograypher_tpu.meshes.mesh import TexturedMesh as JaxTexturedMesh
    from geograypher_tpu_torch.entrypoints.aggregate_images import aggregate_images
    from geograypher_tpu_torch.meshes.mesh import TexturedMesh

    out = tmp_path / "map.geojson"
    pred, _ = aggregate_images(
        mesh_file=survey["mesh_file"], cameras_file=survey["cameras_file"],
        image_folder=survey["image_folder"], label_folder=survey["label_folder"],
        take_every_nth_camera=None, n_classes=survey["n_classes"],
        top_down_vector_projection_savefile=out, device="cpu")
    doc = json.loads(out.read_text())
    assert np.isfinite(pred).mean() > 0.4 and len(doc["features"]) >= 1
    tmesh = TexturedMesh(survey["mesh_file"],
                         transform_filename=survey["cameras_file"], device="cpu")
    jmesh = JaxTexturedMesh(survey["mesh_file"],
                            transform_filename=survey["cameras_file"])
    want = jmesh.export_face_labels_vector(pred)
    assert [f["properties"]["class_ID"] for f in doc["features"]] == want["class_ID"]
    for f, g in zip(doc["features"], want.geometries):
        np.testing.assert_array_equal(f["geometry"]["coordinates"][0], g.exterior)
    assert len(tmesh.export_face_labels_vector(pred)) == len(want)


def test_export_covering_meshes_matches_jax(tmp_path):
    survey = create_example_survey(tmp_path / "s", n_cameras=2,
                                   write_label_images=False)
    from geograypher_tpu.cameras.metashape import MetashapeCameraSet as JaxMeta
    from geograypher_tpu.meshes.mesh import TexturedMesh as JaxTexturedMesh
    from geograypher_tpu_torch.meshes.mesh import TexturedMesh

    jmesh = JaxTexturedMesh(survey["mesh_file"],
                            transform_filename=survey["cameras_file"])
    tmesh = TexturedMesh(survey["mesh_file"],
                         transform_filename=survey["cameras_file"], device="cpu")
    frame = JaxMeta(survey["cameras_file"], survey["image_folder"]
                    ).get_local_to_epsg_4978_transform()
    for kwargs in (dict(N=8), dict(N=5, z_buffer=(5.0, -5.0), subsample=3,
                                   frame_transform=frame)):
        for (tv, tf), (jv, jf) in zip(tmesh.export_covering_meshes(**kwargs),
                                      jmesh.export_covering_meshes(**kwargs)):
            np.testing.assert_array_equal(tv, jv)
            np.testing.assert_array_equal(tf, jf)


def test_tabular_segmentor_matches_jax(tmp_path):
    """Centres and painted rasters per image, at two scales; the packed
    ``bbox`` column; the table's rows and labels."""
    names = ["a.png", "b.png", "c.png"]
    path = box_table(tmp_path, names[:2], np.random.default_rng(4), n_per_image=4)
    j = jseg.TabularRectangleSegmentor(path, image_shape=(80, 80))
    t = tseg.TabularRectangleSegmentor(path, image_shape=(80, 80))
    assert t.num_classes == j.num_classes == 8
    for name in names:
        np.testing.assert_array_equal(t.get_detection_centers(f"x/{name}"),
                                      j.get_detection_centers(f"x/{name}"))
        for scale in (1.0, 0.5):
            np.testing.assert_array_equal(
                t.segment_image(None, filename=name, image_scale=scale),
                j.segment_image(None, filename=name, image_scale=scale))
    for i in range(len(j.df)):
        assert str(t.df.iloc[i].get("label")) == str(j.df.iloc[i].get("label"))
        # float columns to the last bit or two: pandas' fast float parser
        # is not always correctly rounded, Python's float() is
        np.testing.assert_allclose(t.df.iloc[i]["score"], j.df.iloc[i]["score"],
                                   rtol=4e-15, atol=0)
    packed = tmp_path / "packed.csv"
    pd.DataFrame({"image_path": ["a.png"] * 2, "bbox": ["[3, 4, 20, 30]",
                                                        "(10, 12, 50, 40)"],
                  "label": [1, 2]}).to_csv(packed, index=False)
    j = jseg.TabularRectangleSegmentor(packed, image_shape=(60, 60))
    t = tseg.TabularRectangleSegmentor(packed, image_shape=(60, 60))
    np.testing.assert_array_equal(t.get_detection_centers("a.png"),
                                  j.get_detection_centers("a.png"))
    np.testing.assert_array_equal(t.segment_image(None, "a.png"),
                                  j.segment_image(None, "a.png"))
    assert [str(t.df.iloc[i].get("label")) for i in range(2)] == [
        str(j.df.iloc[i].get("label")) for i in range(2)]


def test_small_segmentors_match_jax():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (20, 30, 3))
    np.testing.assert_array_equal(
        tseg.BrightnessSegmentor().segment_image(img),
        jseg.BrightnessSegmentor().segment_image(img))
    labels = [rng.integers(-1, 4, (10, 12)).astype(float) for _ in range(2)]
    np.testing.assert_array_equal(
        tseg.ArraySegmentor(labels, 4).segment_image(None, index=1),
        jseg.ArraySegmentor(labels, 4).segment_image(None, index=1))
    for image in (None, np.zeros((7, 9))):
        np.testing.assert_array_equal(
            tseg.ImageIDSegmentor((40, 60), 5).segment_image(
                image, image_scale=0.5, index=3),
            jseg.ImageIDSegmentor((40, 60), 5).segment_image(
                image, image_scale=0.5, index=3))


def random_polygons(rng, n, h, w):
    """Rectangles anywhere (partly outside the image too) and star-shaped
    integer-vertex polygons inside it."""
    polys = []
    for k in range(n):
        if k % 2 == 0:
            x0, x1 = sorted(rng.integers(-20, w + 20, 2))
            y0, y1 = sorted(rng.integers(-20, h + 20, 2))
            p = np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]])
            polys.append(p[::-1] if rng.random() < 0.5 else p)
        else:
            m = int(rng.integers(3, 12))
            ang = np.sort(rng.uniform(0, 2 * np.pi, m))
            r = rng.uniform(3, min(h, w) / 2.5, m)
            c = rng.uniform(0.35, 0.65, 2) * (w, h)
            p = np.round(np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)],
                                  1)).astype(int)
            p[:, 0] = np.clip(p[:, 0], 0, w - 1)
            p[:, 1] = np.clip(p[:, 1], 0, h - 1)
            polys.append(p)
    return polys


def test_fill_poly_equals_cv2():
    """cv2.fillPoly, pixel for pixel, on 600 rectangles (partly outside
    the image too) and integer-vertex polygons inside it."""
    rng = np.random.default_rng(0)
    h, w = 60, 80
    for p in random_polygons(rng, 600, h, w):
        a = np.full((h, w), -1, np.int32)
        b = a.copy()
        cv2.fillPoly(a, [p.astype(np.int32)], 7)
        fill_poly(b, p, 7)
        np.testing.assert_array_equal(b, a)


def test_fill_poly_slanted_edges_off_the_image():
    """The one difference from cv2 (ROADMAP C4): polygons whose slanted
    edges leave the image.  Over 600 random ones (3-5 vertices up to 40 px
    outside an 80 x 60 image) the fills differ only on pixels of the
    image's outermost rows and columns."""
    rng = np.random.default_rng(1)
    h, w = 60, 80
    differ = 0
    for _ in range(600):
        k = int(rng.integers(3, 6))
        p = np.stack([rng.integers(-40, w + 40, k), rng.integers(-40, h + 40, k)], 1)
        a = np.full((h, w), -1, np.int32)
        b = a.copy()
        cv2.fillPoly(a, [p.astype(np.int32)], 1)
        fill_poly(b, p, 1)
        diff = np.argwhere(a != b)
        differ += len(diff) > 0
        on_border = ((diff[:, 0] == 0) | (diff[:, 0] == h - 1)
                     | (diff[:, 1] == 0) | (diff[:, 1] == w - 1))
        assert on_border.all(), (p.tolist(), diff[~on_border].tolist())
    assert differ < 60


def test_region_segmentor_matches_jax(tmp_path):
    """Per-image polygon files: detection indices, centres and the raster
    (cv2's fill in the JAX package, the port's own here) at two scales."""
    rng = np.random.default_rng(2)
    folder = tmp_path / "dets"
    for k in range(3):
        polys = random_polygons(rng, 4, 60, 80)
        JaxVectorData([JaxPolygon(p.astype(float)) for p in polys],
                      {"label": ["obj"] * 4}).to_file(folder / f"img_{k}.geojson")
    j = jseg.RegionDetectionSegmentor(folder, image_shape=(60, 80))
    t = tseg.RegionDetectionSegmentor(folder, image_shape=(60, 80))
    assert t.num_classes == j.num_classes == 12
    for k in range(4):
        name = f"/some/images/img_{k}.JPG"
        np.testing.assert_array_equal(t.get_detection_centers(name),
                                      j.get_detection_centers(name))
        for scale in (1.0, 0.5):
            np.testing.assert_array_equal(
                t.segment_image(None, filename=name, image_scale=scale),
                j.segment_image(None, filename=name, image_scale=scale))


# -- both entry points on the synthetic survey ------------------------------------


@pytest.fixture(scope="module")
def survey(tmp_path_factory):
    return create_example_survey(tmp_path_factory.mktemp("survey"))


def test_project_detections_matches_jax(survey, tmp_path, monkeypatch):
    """tests/test_entrypoints.py's recipe through both packages.  The
    survey's nadir views put many pixel centres on shared edges, where
    the two float32 setups round apart (ROADMAP C4): the rasters differ
    by face-to-face swaps only, so every detection's pixel total is
    equal; through the JAX package's pix2face, the counts npz is exactly
    equal and so are the polygons and their columns."""
    from geograypher_tpu.cameras.metashape import MetashapeCameraSet as JaxMeta
    from geograypher_tpu.meshes.mesh import TexturedMesh as JaxTexturedMesh
    from geograypher_tpu_torch.cameras.metashape import MetashapeCameraSet
    from geograypher_tpu_torch.meshes.mesh import TexturedMesh

    path = tmp_path / "dets.csv"
    pd.DataFrame({
        "image_path": ["img_0000.png", "img_0000.png", "img_0001.png",
                       "img_0002.png"],
        "xmin": [20, 60, 30, 10], "xmax": [40, 80, 55, 35],
        "ymin": [20, 55, 30, 50], "ymax": [40, 75, 55, 90],
        "label": ["tree_a", "tree_b", "tree_a", "tree_c"],
    }).to_csv(path, index=False)

    def run(name, fn, **extra):
        return fn(
            mesh_file=survey["mesh_file"], cameras_file=survey["cameras_file"],
            image_folder=survey["image_folder"], detections_folder=path,
            image_shape=(96, 96), aggregate_image_scale=1.0,
            projections_to_mesh_savefile=tmp_path / f"{name}.npz",
            projections_to_geospatial_savefile=tmp_path / f"{name}.geojson",
            **extra)

    jc, jv = run("jax", jax_project_detections)
    tc, tv = run("own", project_detections, device="cpu")
    assert tc.nnz > 0 and (tc.toarray().sum(axis=0) > 0).sum() >= 3
    np.testing.assert_array_equal(tc.sum(axis=0), jc.sum(axis=0))
    jp2f = JaxTexturedMesh(survey["mesh_file"],
                           transform_filename=survey["cameras_file"]).pix2face(
        JaxMeta(survey["cameras_file"], survey["image_folder"]))
    tp2f = TexturedMesh(survey["mesh_file"],
                        transform_filename=survey["cameras_file"],
                        device="cpu").pix2face(
        MetashapeCameraSet(survey["cameras_file"], survey["image_folder"]))
    swap = tp2f != jp2f
    assert ((tp2f[swap] >= 0) & (jp2f[swap] >= 0)).all() and swap.mean() < 0.02

    def jax_raster(self, cameras, index, **kw):
        return torch.as_tensor(jp2f[index])

    monkeypatch.setattr(TexturedMesh, "_pix2face_device", jax_raster)
    tc, tv = run("port", project_detections, device="cpu")
    csr_equal(scipy.sparse.load_npz(tmp_path / "port.npz"),
              scipy.sparse.load_npz(tmp_path / "jax.npz"))
    assert tv.attributes == jv.attributes
    assert "tree_b" in tv.attributes["detection_label"]
    tdoc = json.loads((tmp_path / "port.geojson").read_text())
    jdoc = json.loads((tmp_path / "jax.geojson").read_text())
    assert tdoc["crs"] == jdoc["crs"] and len(tdoc["features"]) == len(
        jdoc["features"])
    for a, b in zip(tdoc["features"], jdoc["features"]):
        assert a["properties"] == b["properties"]
        for ra, rb in zip(a["geometry"]["coordinates"], b["geometry"]["coordinates"]):
            np.testing.assert_allclose(ra, rb, atol=DEG_ATOL, rtol=0)


def test_multiview_detections_matches_jax(survey, tmp_path):
    """tests/test_entrypoints.py's recipe (one canopy point seen by every
    camera, square detections around its projections) through both
    packages: the points file equal to 1e-7 degrees, the cache files of
    one package resumed by the other."""
    from geograypher_tpu.cameras.metashape import MetashapeCameraSet as JaxMeta
    from geograypher_tpu.meshes.mesh import TexturedMesh as JaxTexturedMesh

    cams = JaxMeta(survey["cameras_file"], survey["image_folder"])
    mesh = JaxTexturedMesh(survey["mesh_file"],
                           transform_filename=survey["cameras_file"])
    local = mesh.get_verts_in_local_frame(cams)
    pts3 = np.stack([local.mean(axis=0), local.mean(axis=0) + [4.0, -3.0, 0.0]])
    pts3[:, 2] = local[:, 2].max()
    xy, _, valid = (np.asarray(x) for x in jax_project_points(
        cams.get_camera_batch(), jnp.asarray(pts3, jnp.float32)))
    det_dir = tmp_path / "dets"
    for i in range(len(cams)):
        polys = [JaxPolygon(np.array([[x - 3, y - 3], [x + 3, y - 3], [x + 3, y + 3],
                                      [x - 3, y + 3]]))
                 for (x, y), ok in zip(xy[i], valid[i]) if ok]
        if polys:
            JaxVectorData(polys, {"label": ["obj"] * len(polys)}).to_file(
                det_dir / f"img_{i:04d}.geojson")
    common = dict(mesh_file=survey["mesh_file"], cameras_file=survey["cameras_file"],
                  image_folder=survey["image_folder"], detections_folder=det_dir,
                  ray_length_meters=200.0, similarity_threshold_meters=2.0,
                  covering_mesh_N=8, covering_z_buffer=(5.0, -5.0))
    want = jax_multiview_detections(out_dir=tmp_path / "jc",
                                    triangulated_points_savefile=tmp_path / "j.geojson",
                                    **common)
    got = multiview_detections(out_dir=tmp_path / "tc",
                               triangulated_points_savefile=tmp_path / "t.geojson",
                               device="cpu", **common)
    assert len(got) == len(want) >= 1
    np.testing.assert_allclose(got[:, :2], want[:, :2], atol=DEG_ATOL, rtol=0)
    np.testing.assert_allclose(got[:, 2], want[:, 2], atol=1e-3)
    tdoc = json.loads((tmp_path / "t.geojson").read_text())
    jdoc = json.loads((tmp_path / "j.geojson").read_text())
    assert len(tdoc["features"]) == len(jdoc["features"])
    for a, b in zip(tdoc["features"], jdoc["features"]):
        np.testing.assert_allclose(a["geometry"]["coordinates"],
                                   b["geometry"]["coordinates"], atol=DEG_ATOL)
        assert a["properties"]["altitude"] == pytest.approx(
            b["properties"]["altitude"], abs=1e-3)
    shutil.copytree(tmp_path / "jc", tmp_path / "tj")
    np.testing.assert_array_equal(
        multiview_detections(out_dir=tmp_path / "tj", device="cpu", **common), want)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(survey, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    common = dict(mesh_file=survey["mesh_file"], cameras_file=survey["cameras_file"],
                  image_folder=survey["image_folder"], detections_folder=tmp_path)
    for fn in (project_detections, multiview_detections):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(**common)


def test_entry_points_registered_and_parse():
    import sys

    from geograypher_tpu_torch import entrypoints
    from geograypher_tpu_torch.entrypoints import multiview_detections as mv
    from geograypher_tpu_torch.entrypoints import project_detections as pdm

    assert {"project_detections", "multiview_detections"} <= set(entrypoints.__all__)
    argv = sys.argv
    try:
        sys.argv = ["x", "--mesh-file", "m", "--cameras-file", "c",
                    "--image-folder", "i", "--detections-folder", "d",
                    "--device", "cpu"]
        assert vars(pdm.parse_args())["device"] == "cpu"
        assert vars(mv.parse_args())["similarity_threshold_meters"] == 0.5
    finally:
        sys.argv = argv
