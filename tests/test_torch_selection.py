"""Image selection (``entrypoints/annotation_image_selection.py``) of the
PyTorch port against the JAX package on the CPU.

The greedy cover on the device (``greedy_set_cover_sparse``) and the
plain one (the JAX loop) pick what the JAX package's ``greedy_set_cover``
picks, pick for pick, on seeded random matrices with ties, empty rows and
empty columns.  The entry point on ``tests/test_entrypoints.py``'s survey
at scale 0.5: through the JAX package's pix2face its visibility and picks
equal the JAX entry point's exactly; on its own raster the visibility
differs only on faces whose pixels swap between the two float32 setups
(ROADMAP C4: 2 faces on this survey), and both greedies on
the port's matrix agree and cover every seen face."""

import numpy as np
import pytest
import scipy.sparse
import torch

from geograypher_tpu.entrypoints.annotation_image_selection import (
    determine_minimum_overlapping_images as jax_determine,
)
from geograypher_tpu.entrypoints.annotation_image_selection import (
    greedy_set_cover as jax_greedy,
)
from geograypher_tpu.utils.example_data import create_example_survey
from geograypher_tpu_torch.entrypoints import annotation_image_selection as sel
from geograypher_tpu_torch.meshes.mesh import TexturedMesh
from tests.test_torch_rasterize import one_torch_thread  # noqa: F401

SCALE = 0.5


def _matrix(seed):
    """A seeded (faces, images) boolean matrix: random density, some
    images that duplicate others (ties), empty rows and empty columns."""
    rng = np.random.default_rng(seed)
    n_faces, n_images = int(rng.integers(1, 80)), int(rng.integers(1, 14))
    m = rng.random((n_faces, n_images)) < rng.uniform(0.02, 0.6)
    if n_images > 2:
        m[:, 2] = m[:, 0]  # a tie, broken towards the lower index
        m[:, rng.integers(0, n_images)] = False  # an image that sees nothing
    m[rng.integers(0, n_faces, 3)] = False  # faces no image sees
    return m


@pytest.mark.parametrize("seed", range(24))
def test_greedy_picks_equal_the_jax_greedy(seed):
    m = _matrix(seed)
    want = jax_greedy(m)
    assert sel.greedy_set_cover(m) == want
    assert sel.greedy_set_cover_sparse(scipy.sparse.csr_array(m), device="cpu") == want
    covered = m[:, want].any(axis=1) if want else np.zeros(len(m), bool)
    np.testing.assert_array_equal(covered, m.any(axis=1))


def test_greedy_edge_cases():
    for m in (np.zeros((0, 3), bool), np.zeros((4, 0), bool), np.zeros((5, 3), bool),
              np.ones((3, 4), bool), np.eye(5, dtype=bool)):
        want = jax_greedy(m)
        assert sel.greedy_set_cover(m) == want
        assert sel.greedy_set_cover_sparse(scipy.sparse.csr_array(m), "cpu") == want
    # stored zeros are not visibility
    m = scipy.sparse.csr_array((np.array([True, False]), (np.array([0, 1]),
                                                          np.array([0, 1]))), shape=(2, 2))
    assert sel.greedy_set_cover_sparse(m, "cpu") == [0]


def test_visibility_matrix_thresholds_the_counts():
    counts = scipy.sparse.csr_array(np.array([[0, 3, 1], [2, 0, 0], [0, 0, 0]],
                                             np.float32))
    for m in (1, 2, 3):
        np.testing.assert_array_equal(sel.visibility_matrix(counts, m).toarray(),
                                      counts.toarray() >= m)
    with pytest.raises(ValueError, match="at least 1"):
        sel.visibility_matrix(counts, 0)


@pytest.fixture(scope="module")
def survey(tmp_path_factory):
    return create_example_survey(tmp_path_factory.mktemp("survey"))


def _files(survey):
    return dict(mesh_file=survey["mesh_file"], cameras_file=survey["cameras_file"],
                image_folder=survey["image_folder"], aggregate_image_scale=SCALE)


def _jax_visibility(survey):
    """The JAX entry point's visibility, as its function computes it."""
    from geograypher_tpu.cameras.metashape import MetashapeCameraSet as JaxMeta
    from geograypher_tpu.cameras.segmentor_set import SegmentorCameraSet as JaxSeg
    from geograypher_tpu.meshes.mesh import TexturedMesh as JaxTexturedMesh
    from geograypher_tpu.meshes.sparse import aggregate_index_predictions
    from geograypher_tpu.predictors.segmentors import ImageIDSegmentor

    cams = JaxMeta(survey["cameras_file"], survey["image_folder"])
    mesh = JaxTexturedMesh(survey["mesh_file"], transform_filename=survey["cameras_file"])
    sensor = cams.sensors[cams.sensor_IDs[0]]
    seg = JaxSeg(cams, ImageIDSegmentor((sensor["image_height"], sensor["image_width"]),
                                        len(cams)))
    counts, _ = aggregate_index_predictions(mesh, seg, n_classes=len(cams),
                                            aggregate_img_scale=SCALE,
                                            check_null_image=False)
    return mesh, cams, (counts >= 1).toarray()


def test_selection_through_the_jax_pix2face_equals_jax(survey, tmp_path, monkeypatch):
    """The port's entry point on the JAX package's pix2face: the same
    visibility and the same picks as the JAX entry point, and the mask
    and image copies it saves."""
    jmesh, jcams, want_vis = _jax_visibility(survey)
    jp2f = jmesh.pix2face(jcams, render_img_scale=SCALE)

    def jax_raster(self, cameras, index, **kw):
        return torch.as_tensor(jp2f[index])

    monkeypatch.setattr(TexturedMesh, "_pix2face_device", jax_raster)
    stats = {}
    got = sel.determine_minimum_overlapping_images(
        **_files(survey), device="cpu", stats=stats,
        selected_images_mask_savefile=tmp_path / "mask.npy",
        selected_images_savefolder=tmp_path / "chosen")
    want = jax_determine(**_files(survey))
    assert got == want and 1 <= len(got) <= 4
    np.testing.assert_array_equal(stats["visibility"].toarray(), want_vis)
    assert stats["seen_faces"] == int(want_vis.any(axis=1).sum())
    mask = np.load(tmp_path / "mask.npy")
    assert mask.tolist() == [i in got for i in range(len(jcams))]
    copied = sorted(p.name for p in (tmp_path / "chosen").iterdir())
    names = sorted(jcams.get_image_filename(i).name for i in got
                   if jcams.get_image_filename(i).exists())
    assert copied == names


def test_selection_on_the_ports_raster(survey):
    """On the port's own raster the visibility differs from the JAX
    package's only on faces at pixels whose face swaps between the two
    float32 setups (2 faces here); both greedies agree on the port's
    matrix and its picks cover every seen face."""
    jmesh, jcams, want_vis = _jax_visibility(survey)
    stats = {}
    got = sel.determine_minimum_overlapping_images(**_files(survey), device="cpu",
                                                   stats=stats)
    vis = stats["visibility"]
    dense = vis.toarray()
    assert got == sel.greedy_set_cover(dense) == jax_greedy(dense)
    seen = dense.any(axis=1)
    assert seen.sum() > 0.3 * len(seen)
    assert dense[:, got].any(axis=1)[seen].all()
    assert set(stats) >= {"load_s", "aggregate_s", "greedy_s", "views"}
    assert len(stats["views"]) == len(jcams)

    jp2f = jmesh.pix2face(jcams, render_img_scale=SCALE)
    tmesh = TexturedMesh(survey["mesh_file"], transform_filename=survey["cameras_file"],
                         device="cpu")
    from geograypher_tpu_torch.cameras.metashape import MetashapeCameraSet

    tp2f = tmesh.pix2face(MetashapeCameraSet(survey["cameras_file"],
                                             survey["image_folder"]),
                          render_img_scale=SCALE)
    swap = tp2f != jp2f
    assert ((tp2f[swap] >= 0) & (jp2f[swap] >= 0)).all()
    swapped = np.union1d(tp2f[swap], jp2f[swap])
    differ = np.flatnonzero((dense != want_vis).any(axis=1))
    assert np.isin(differ, swapped).all()
    assert len(differ) == 2


def test_selection_sizes_its_caps_by_a_census_at_its_defaults(survey):
    """Caps that a view's tile lists overflow, given as the
    ``raster_config``, raise (C9); without a ``raster_config`` the entry
    point sizes the caps by a census of its views (on a 1M-face mesh at the
    default scale the default caps overflow so: ``chip_smoke.py`` 11d) and
    picks what a run at those caps picks."""
    from geograypher_tpu_torch.cameras.metashape import MetashapeCameraSet
    from geograypher_tpu_torch.ops.rasterize import RasterConfig
    from geograypher_tpu_torch.parallel.planner import census_caps

    small = RasterConfig(caps=(16, 16, 16, 16))
    with pytest.raises(RuntimeError, match="overflow"):
        sel.determine_minimum_overlapping_images(**_files(survey), device="cpu",
                                                 raster_config=small)
    stats = {}
    got = sel.determine_minimum_overlapping_images(**_files(survey), device="cpu",
                                                   stats=stats)
    caps = stats["caps"]
    mesh = TexturedMesh(survey["mesh_file"], transform_filename=survey["cameras_file"],
                        device="cpu")
    cams = MetashapeCameraSet(survey["cameras_file"], survey["image_folder"])
    assert census_caps(mesh.view_raster_census(cams, SCALE), mesh.raster_config).caps == caps
    assert caps[0] > small.caps[0]
    want = sel.determine_minimum_overlapping_images(
        **_files(survey), device="cpu", raster_config=RasterConfig(caps=caps))
    assert got == want and len(got) >= 1


def test_selection_needs_a_card_unless_asked_for_the_cpu(survey):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sel.determine_minimum_overlapping_images(**_files(survey))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sel.greedy_set_cover_sparse(scipy.sparse.csr_array(np.eye(2, dtype=bool)))


def test_selection_entry_point_registered_and_parses(monkeypatch):
    import sys

    from geograypher_tpu_torch import entrypoints

    assert "determine_minimum_overlapping_images" in entrypoints.__all__
    assert entrypoints.__getattr__("determine_minimum_overlapping_images") is (
        sel.determine_minimum_overlapping_images)
    monkeypatch.setattr(sys, "argv", ["x", "--mesh-file", "m", "--cameras-file", "c",
                                      "--image-folder", "i", "--device", "cpu"])
    args = vars(sel.parse_args())
    assert args["device"] == "cpu" and args["aggregate_image_scale"] == 0.05
    assert args["min_observations"] == 1
