"""The port's chunked paths (``geograypher_tpu_torch/meshes/chunked.py``)
and its KMeans (``utils/kmeans.py``) against the JAX package's and
sklearn's on the CPU (JAX Pallas in interpret mode): chunked aggregation,
the chunked survey pipeline and chunked rendering on a scene of two
camera clusters whose buffered boxes cut the mesh, with no vertex near a
box edge; the entry points' chunk options; ``batch_size``."""

from pathlib import Path

import numpy as np
import pytest
from sklearn.cluster import KMeans

from geograypher_tpu.cameras.core import CameraSet as JaxCameraSet
from geograypher_tpu.cameras.segmentor_set import (
    SegmentorCameraSet as JaxSegmentorCameraSet,
)
from geograypher_tpu.meshes import chunked as jchunked
from geograypher_tpu.meshes.mesh import TexturedMesh as JaxTexturedMesh
from geograypher_tpu.ops import rasterize as jr
from geograypher_tpu.predictors.segmentors import ArraySegmentor
from geograypher_tpu_torch import interop
from geograypher_tpu_torch.cameras.core import CameraSet
from geograypher_tpu_torch.entrypoints.aggregate_images import aggregate_images
from geograypher_tpu_torch.entrypoints.render_labels import render_labels
from geograypher_tpu_torch.meshes import chunked as tchunked
from geograypher_tpu_torch.meshes.mesh import TexturedMesh
from geograypher_tpu_torch.parallel import pipeline as tpipeline
from geograypher_tpu_torch.utils.example_data import create_example_survey
from geograypher_tpu_torch.utils.fixtures import make_grid_mesh, nadir_camera
from geograypher_tpu_torch.utils.io import read_image_or_numpy
from geograypher_tpu_torch.utils.kmeans import kmeans
from geograypher_tpu_torch.utils.vector import Polygon, VectorData
from tests.test_torch_pipeline import (
    FRAC_ATOL,
    JAX_FEWEST,
    assert_pipelines_agree,
    jax_view_mesh,
    swapped_faces,
)
from tests.test_torch_rasterize import one_torch_thread  # noqa: F401

N_CLASSES = 3
W = H = 64
BUFFER = 0.85  # metres of the local frame around each cluster's cameras


class NamedLabels(ArraySegmentor):
    """Label images found by the view's image file name, as
    ``LookUpSegmentor`` finds them, so a subset of the cameras (a chunk)
    keeps each view's labels (``ArraySegmentor`` goes by the index in the
    set it is asked through)."""

    def __init__(self, label_images, names):
        super().__init__(label_images, N_CLASSES)
        self.row = {name: i for i, name in enumerate(names)}

    def segment_image(self, image, filename=None, image_scale=1.0, index=None, **kw):
        return super().segment_image(image, index=self.row[Path(filename).name])


def partition(labels):
    return sorted(sorted(np.where(labels == k)[0].tolist()) for k in np.unique(labels))


# -- KMeans ------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [2, 3, 5])
def test_kmeans_partitions_equal_sklearn(seed, k):
    """Well-separated clusters of camera-like points (uneven sizes, one
    far from the rest): the port's partition is sklearn's, up to the
    clusters' numbering."""
    rng = np.random.default_rng(seed)
    angle = 2 * np.pi * np.arange(k) / k + rng.uniform(0, 0.3)
    centres = 1000 * np.stack([np.cos(angle), np.sin(angle)], axis=1)
    points = np.concatenate([c + rng.normal(0, 20, (rng.integers(3, 30), 2))
                             for c in centres])
    got, got_centres = kmeans(points, k, seed=seed)
    want = KMeans(n_clusters=k, n_init=10, random_state=seed).fit_predict(points)
    assert partition(got) == partition(want)
    assert got_centres.shape == (k, 2)
    again, _ = kmeans(points, k, seed=seed)
    np.testing.assert_array_equal(again, got)


def test_kmeans_edges():
    pts = np.zeros((4, 2))
    labels, _ = kmeans(pts, 3)  # fewer distinct points than clusters
    assert labels.shape == (4,)
    assert kmeans(np.arange(6.0).reshape(3, 2), 1)[0].tolist() == [0, 0, 0]
    with pytest.raises(ValueError, match="n_clusters"):
        kmeans(pts, 5)


# -- two camera clusters cutting the mesh -------------------------------------------


def chunk_scene():
    """A 17 x 17 grid (vertices every 0.25 m) and two mirrored clusters of
    three nadir views each, off the pixel grid; each cluster's box grown
    by ``BUFFER`` keeps 0.02 m or more from every vertex column and row,
    and holds about a fifth of the faces."""
    verts, faces = make_grid_mesh(n=17, size=4.0,
                                  z_fn=lambda x, y: 0.05 * np.sin(2 * x))
    c2ws = []
    for side in (-1.0, 1.0):
        for k in range(3):
            c2w = nadir_camera(2.0, 40.0, W)
            c2w[:3, 3] += (side * (0.95 + 0.05 * k - 0.0123),
                           0.4 * (k - 1) - 0.0217, 0.0)
            c2ws.append(c2w)
    rng = np.random.default_rng(3)
    face_labels = rng.integers(0, N_CLASSES, len(faces)).astype(float)
    labels = rng.integers(-1, N_CLASSES, (len(c2ws), H, W))
    return verts, faces, face_labels, c2ws, labels


@pytest.fixture(scope="module")
def scene():
    verts, faces, face_labels, c2ws, labels = chunk_scene()
    jcfg = jr.RasterConfig(caps=(256, 64, 32, 16), backend="pallas")
    jmesh = JaxTexturedMesh((verts, faces), raster_config=jcfg)
    jmesh.set_texture(face_labels, is_vertex=False)
    names = [f"view_{k}.png" for k in range(len(c2ws))]
    jcams = JaxCameraSet(c2ws, {0: {"f": 40.0, "cx": 0.0, "cy": 0.0,
                                    "image_width": W, "image_height": H}},
                         image_filenames=names)
    jseg = JaxSegmentorCameraSet(jcams, NamedLabels(labels, names))
    tmesh = interop.mesh_from_jax(jmesh, device="cpu")
    tcams = interop.cameras_from_jax(jcams)
    tseg = interop.cameras_from_jax(jseg)
    # the chunks of both packages, and the faces a knife-edge swap touches
    clusters = tchunked.cluster_cameras(tcams, 2)
    swapped = np.zeros(tmesh.n_faces, bool)
    for idx in clusters:
        sub_j, ids = jchunked.mesh_chunk_for_cameras(jmesh, jcams, idx, BUFFER)
        sub_t, ids_t = tchunked.mesh_chunk_for_cameras(tmesh, tcams, idx, BUFFER)
        np.testing.assert_array_equal(ids_t, ids)
        assert 0.15 * tmesh.n_faces < len(ids) < 0.6 * tmesh.n_faces
        sub_swapped, share = swapped_faces(sub_j, jcams.get_subset_cameras(idx),
                                           sub_t, tcams.get_subset_cameras(idx), jcfg)
        assert share < 0.01
        swapped[ids[sub_swapped]] = True
    return jmesh, jcams, jseg, tmesh, tcams, tseg, labels, clusters, swapped


def test_clusters_equal_sklearn(scene):
    *_, tcams, _, _, clusters, _ = scene
    assert sorted(map(list, clusters)) == [[0, 1, 2], [3, 4, 5]]
    want = jchunked.cluster_cameras(scene[1], 2)
    assert sorted(map(list, want)) == sorted(map(list, clusters))


def test_aggregate_images_chunked_matches_jax(scene):
    jmesh, _, jseg, tmesh, _, tseg, _, _, swapped = scene
    avg_j, info_j = jchunked.aggregate_images_chunked(
        jmesh, jseg, n_clusters=2, buffer_meters=BUFFER)
    avg, info = tchunked.aggregate_images_chunked(
        tmesh, tseg, n_clusters=2, buffer_meters=BUFFER)
    keep = ~swapped
    assert keep.mean() > 0.8
    np.testing.assert_array_equal(info["projection_counts"][keep],
                                  info_j["projection_counts"][keep])
    np.testing.assert_array_equal(np.isnan(avg[keep]), np.isnan(avg_j[keep]))
    np.testing.assert_allclose(avg[keep], avg_j[keep], atol=FRAC_ATOL, equal_nan=True)
    # the chunks cut the mesh: what no chunk keeps is unseen
    kept = np.zeros(tmesh.n_faces, bool)
    for idx in scene[7]:
        kept[tchunked.mesh_chunk_for_cameras(tmesh, scene[4], idx, BUFFER)[1]] = True
    whole = tmesh.aggregate_projected_images(tseg)[1]["projection_counts"]
    assert (whole[~kept] > 0).any() and not info["projection_counts"][~kept].any()


def test_chunked_pipeline_matches_jax(scene):
    jmesh, jcams, _, tmesh, tcams, _, labels, _, swapped = scene
    want = jchunked.aggregate_class_images_chunked_distributed(
        jmesh, jcams, N_CLASSES, n_clusters=2, buffer_meters=BUFFER,
        class_image_provider=lambda i: labels[i], device_mesh=jax_view_mesh(2),
        **JAX_FEWEST)
    port = tchunked.aggregate_class_images_chunked_distributed(
        tmesh, tcams, N_CLASSES, n_clusters=2, buffer_meters=BUFFER,
        class_image_provider=lambda i: labels[i], device_mesh=["cpu", "cpu"])
    assert_pipelines_agree(port, want, swapped)
    # a buffer over the whole scene: the chunked pipeline is the pipeline
    whole = tpipeline.aggregate_class_images_distributed(
        tmesh, tcams, N_CLASSES, class_image_provider=lambda i: labels[i],
        device_mesh=["cpu"])
    cover = tchunked.aggregate_class_images_chunked_distributed(
        tmesh, tcams, N_CLASSES, n_clusters=2, buffer_meters=10.0,
        class_image_provider=lambda i: labels[i], device_mesh=["cpu"])
    np.testing.assert_array_equal(cover[1], whole[1])
    np.testing.assert_allclose(cover[0], whole[0], rtol=1e-6, atol=1e-6)


def test_render_flat_chunked_matches_jax(scene):
    """Every camera once, from its cluster's sub-mesh: the NaN (unseen)
    pattern exactly the JAX package's, the labels on at least 99% of the
    pixels (knife-edge swaps)."""
    jmesh, jcams, _, tmesh, tcams, *_ = scene
    c2w = [np.asarray(t) for t in tcams.cam_to_world_transforms]

    def by_view(renders):
        out = {}
        for img, cam in renders:
            k, = [i for i, t in enumerate(c2w)
                  if np.allclose(t, cam.cam_to_world_transforms[0])]
            out[k] = np.asarray(img)
        return out

    want = by_view(jchunked.render_flat_chunked(jmesh, jcams, n_cameras_per_chunk=3,
                                                buffer_meters=BUFFER))
    got = by_view(tchunked.render_flat_chunked(tmesh, tcams, n_cameras_per_chunk=3,
                                               buffer_meters=BUFFER))
    assert sorted(got) == sorted(want) == list(range(len(c2w)))
    for k in got:
        assert got[k].shape == (H, W, 1)
        np.testing.assert_array_equal(np.isnan(got[k]), np.isnan(want[k]))
        same = (got[k] == want[k]) | np.isnan(want[k])
        assert same.mean() >= 0.99
        assert np.isnan(got[k]).any() and np.isfinite(got[k]).any()


def test_mesh_chunk_is_an_exact_box():
    """The chunk keeps exactly the faces whose three vertices lie in the
    cameras' box grown by the buffer."""
    verts, faces, _, c2ws, _ = chunk_scene()
    tmesh = TexturedMesh((verts, faces), device="cpu")
    tcams = CameraSet(c2ws)
    sub, ids = tchunked.mesh_chunk_for_cameras(tmesh, tcams, [0, 1, 2], BUFFER)
    xy = tcams.get_camera_locations()[:3, :2]
    lo, hi = xy.min(axis=0) - BUFFER, xy.max(axis=0) + BUFFER
    inside = ((verts[:, :2] >= lo) & (verts[:, :2] <= hi)).all(axis=1)
    np.testing.assert_array_equal(ids, np.where(inside[faces].all(axis=1))[0])
    assert sub.n_faces == len(ids)
    np.testing.assert_allclose(sub.verts[sub.faces], verts[faces[ids]])


def test_label_polygons_chunked_waits_for_a6(scene):
    """Since A6 (polygon labelling) is ported: polygons in spatial clusters
    of four, each cluster labelled against the mesh, give the JAX
    package's labels in the polygons' order (the exact mode; a polygon's
    label does not depend on its cluster)."""
    from geograypher_tpu.utils.vector import Polygon as JaxPolygon
    from geograypher_tpu.utils.vector import VectorData as JaxVectorData

    jmesh, tmesh = scene[0], scene[3]
    labels = np.asarray(chunk_scene()[2])
    rng = np.random.default_rng(5)
    rings = [np.array([cx, cy]) + np.array([[0, 0], [0.5, 0.05], [0.4, 0.45], [-0.1, 0.4]])
             for cx, cy in rng.uniform(-1.8, 1.3, (12, 2))]
    got = tchunked.label_polygons_chunked(
        tmesh, labels, VectorData([Polygon(r) for r in rings]), polygons_per_cluster=4,
        mode="exact")
    want = jchunked.label_polygons_chunked(
        jmesh, labels, JaxVectorData([JaxPolygon(r) for r in rings]),
        polygons_per_cluster=4, mode="exact")
    assert got == want and len(got) == 12 and None not in got


# -- the entry points' chunk options, batch_size -------------------------------------


@pytest.fixture(scope="module")
def survey(tmp_path_factory):
    return create_example_survey(tmp_path_factory.mktemp("survey"), device="cpu")


def test_render_labels_chunked(survey, tmp_path):
    """``n_cameras_per_chunk=2`` (``tests/test_entrypoints.py:154``): 4
    masks with background 255; the default 125 m buffer covers the 40 m
    scene, so every file equals the unchunked one."""
    kwargs = dict(mesh_file=survey["mesh_file"], cameras_file=survey["cameras_file"],
                  image_folder=survey["image_folder"],
                  texture=survey["labels_vector_file"], texture_column_name="species",
                  ROI_buffer_radius_meters=200.0, device="cpu")
    render_labels(render_savefolder=tmp_path / "chunked", n_cameras_per_chunk=2,
                  **kwargs)
    render_labels(render_savefolder=tmp_path / "whole", **kwargs)
    files = sorted((tmp_path / "chunked").glob("*.png"))
    assert len(files) == 4
    assert [f.name for f in files] == sorted(
        f.name for f in (tmp_path / "whole").glob("*.png"))
    for f in files:
        mask = read_image_or_numpy(f)
        assert 255 in np.unique(mask) and mask.dtype == np.uint8
        np.testing.assert_array_equal(mask, read_image_or_numpy(tmp_path / "whole" / f.name))


@pytest.mark.parametrize("option", [dict(n_aggregation_clusters=2),
                                    dict(n_cameras_per_aggregation_cluster=2)])
def test_aggregate_images_chunked_entry(survey, option):
    """Both cluster options take the chunked route; with the scene inside
    every chunk's buffer it returns what the unchunked route does."""
    kwargs = dict(mesh_file=survey["mesh_file"], cameras_file=survey["cameras_file"],
                  image_folder=survey["image_folder"], label_folder=survey["label_folder"],
                  take_every_nth_camera=None, n_classes=survey["n_classes"],
                  device="cpu")
    pred, avg = aggregate_images(**option, **kwargs)
    pred_w, avg_w = aggregate_images(**kwargs)
    np.testing.assert_array_equal(pred, pred_w)
    np.testing.assert_allclose(avg, avg_w, atol=1e-6, equal_nan=True)
    assert np.isfinite(pred).mean() > 0.4


def test_batch_size_accepted(scene):
    """Any ``batch_size >= 1`` gives the results of 1, as in the JAX
    package, which ignores it; 0 is refused."""
    *_, tmesh, tcams, tseg, _, _, _ = scene
    one = [s.numpy() for s, _ in tmesh.project_images(tseg)]
    three = [s.numpy() for s, _ in tmesh.project_images(tseg, batch_size=3)]
    assert all(np.array_equal(a, b) for a, b in zip(one, three))
    r1 = list(tmesh.render_flat(tcams))
    r4 = list(tmesh.render_flat(tcams, batch_size=4))
    assert all(np.array_equal(a, b, equal_nan=True) for a, b in zip(r1, r4))
    a1 = tmesh.aggregate_projected_images(tseg)[0]
    a8 = tmesh.aggregate_projected_images(tseg, batch_size=8)[0]
    np.testing.assert_array_equal(a1, a8)
    for call in (lambda: list(tmesh.render_flat(tcams, batch_size=0)),
                 lambda: list(tmesh.project_images(tseg, batch_size=0)),
                 lambda: tmesh.aggregate_projected_images(tseg, batch_size=0)):
        with pytest.raises(ValueError, match="batch_size"):
            call()
