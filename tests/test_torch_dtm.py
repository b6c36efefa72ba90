"""The DTM workflows and the entry points of the port's A6 slice against
the JAX package, on ``create_example_survey`` (a 40 m scene of boxes on
the ground, 4 nadir 96 x 96 views, a flat DTM) and on a sloped DTM of the
same site.

* per-vertex raster samples, heights above ground, the ground relabel of
  vertex and face labels, ``.tif`` textures and face area ratios: equal to
  the JAX package's (host numpy in both);
* ``render_height_masks`` (uint8 masks, float ``.npy`` renders),
  ``aggregate_images`` and ``render_labels`` with a DTM: the port's raster
  and the JAX package's XLA raster part on knife-edge pixels (ROADMAP C4),
  so files agree on >= 99% of pixels and predicted classes on >= 99% of
  faces;
* ``label_polygons`` (the entry point, with and without the DTM's ground
  down-weighting): equal labels through the same pix2face, and equal on
  each package's own raster here.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest

from geograypher_tpu.entrypoints.aggregate_images import aggregate_images as jax_aggregate
from geograypher_tpu.entrypoints.label_polygons import label_polygons as jax_label_polygons
from geograypher_tpu.entrypoints.render_height_masks import (
    render_height_masks as jax_height_masks,
)
from geograypher_tpu.entrypoints.render_labels import render_labels as jax_render_labels
from geograypher_tpu.meshes.mesh import TexturedMesh as JaxTexturedMesh
from geograypher_tpu.ops.aggregate import find_argmax_nonzero_value
from geograypher_tpu.ops.rasterize import RasterConfig as JaxRasterConfig
from geograypher_tpu.utils.example_data import create_example_survey as jax_survey
from geograypher_tpu.utils.raster import read_geotiff as jax_read_geotiff
from geograypher_tpu_torch import entrypoints
from geograypher_tpu_torch.entrypoints.aggregate_images import aggregate_images
from geograypher_tpu_torch.entrypoints.label_polygons import label_polygons
from geograypher_tpu_torch.entrypoints.render_height_masks import render_height_masks
from geograypher_tpu_torch.entrypoints.render_labels import render_labels
from geograypher_tpu_torch.meshes.mesh import TexturedMesh
from geograypher_tpu_torch.utils.example_data import create_example_survey
from geograypher_tpu_torch.utils.io import read_image_or_numpy
from geograypher_tpu_torch.utils.raster import Raster, read_geotiff, write_geotiff
from tests.test_torch_rasterize import knife_edge, one_torch_thread  # noqa: F401

XLA = JaxRasterConfig(caps=(640, 160, 64, 32), backend="xla")


@pytest.fixture(scope="module")
def survey(tmp_path_factory):
    folder = tmp_path_factory.mktemp("dtm_survey")
    s = create_example_survey(folder, device="cpu")
    # a DTM sloping 0.05 m a metre east, 0.5 m below the flat ground at
    # the site's centre: heights above ground 0-2.5 m across the ground
    flat = read_geotiff(s["dtm_file"])  # 80 m a side around the site
    n = 80
    a, _, c, _, e, f = flat.transform
    a, e = a * 64 / n, e * 64 / n
    east = (np.arange(n) + 0.5) * a - 40.0
    heights = np.broadcast_to(-0.5 + 0.05 * east, (n, n)).astype(np.float32)
    write_geotiff(folder / "slope.tif", Raster(heights, (a, 0.0, c, 0.0, e, f),
                                               flat.epsg, nodata=-9999.0))
    s["slope_file"] = folder / "slope.tif"
    return s


def meshes(survey):
    kw = dict(transform_filename=survey["cameras_file"])
    return (TexturedMesh(survey["mesh_file"], device="cpu", **kw),
            JaxTexturedMesh(survey["mesh_file"], raster_config=XLA, **kw))


def test_example_survey_dtm_matches_jax(survey, tmp_path):
    """The survey's DTM file is the JAX survey's: the same Raster."""
    want = jax_read_geotiff(jax_survey(tmp_path, write_label_images=False)["dtm_file"])
    got = read_geotiff(survey["dtm_file"])
    np.testing.assert_array_equal(got.data, want.data)
    assert tuple(got.transform) == tuple(want.transform) and got.epsg == want.epsg
    assert got.data.shape == (64, 64) and got.nodata is None


@pytest.mark.parametrize("method", ["nearest", "bilinear"])
@pytest.mark.parametrize("dtm", ["dtm_file", "slope_file", "geographic"])
def test_values_for_verts_from_raster_match_jax(survey, tmp_path, dtm, method):
    """Per-vertex samples in the raster's CRS, a projected and a
    geographic one (lon, lat axes), NaN off the raster."""
    path = survey["slope_file"] if dtm == "geographic" else survey[dtm]
    if dtm == "geographic":
        from geograypher_tpu_torch.utils.raster import reproject_raster

        reproject_raster(path, tmp_path / "geo.tif", 4326, method="bilinear")
        path = tmp_path / "geo.tif"
    tmesh, jmesh = meshes(survey)
    got = tmesh.get_values_for_verts_from_raster(path, method=method)
    want = jmesh.get_values_for_verts_from_raster(path, method=method)
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).mean() > 0.9


@pytest.mark.parametrize("threshold", [None, 1.0])
def test_height_above_ground_matches_jax(survey, threshold):
    tmesh, jmesh = meshes(survey)
    got = tmesh.get_height_above_ground(survey["slope_file"], threshold=threshold)
    want = jmesh.get_height_above_ground(survey["slope_file"], threshold=threshold)
    np.testing.assert_array_equal(got, want)
    if threshold is not None:
        assert got.dtype == bool and 0 < got.mean() < 1


@pytest.mark.parametrize("case", ["vertex", "face", "texture", "named", "existing_only"])
def test_label_ground_class_matches_jax(survey, case):
    """Vertex labels, face labels (majority of the vertices), the mesh's
    own texture (installed with the ground name), a named ground class,
    and relabelling only finite labels or every vertex."""
    tmesh, jmesh = meshes(survey)
    rng = np.random.default_rng(0)
    kw = dict(height_above_ground_threshold=1.0)
    if case == "face":
        kw["labels"] = rng.integers(0, 3, tmesh.n_faces).astype(float)
    elif case in ("vertex", "existing_only"):
        labels = rng.integers(0, 3, tmesh.n_verts).astype(float)
        labels[::5] = np.nan
        kw["labels"] = labels
        kw["only_label_existing_labels"] = case == "vertex"
    else:
        tex = rng.integers(0, 3, tmesh.n_verts).astype(float)
        ids = {0: "a", 1: "ground", 2: "b"} if case == "named" else {0: "a", 1: "b", 2: "c"}
        tmesh.set_texture(tex, is_vertex=True, IDs_to_labels=ids)
        jmesh.set_texture(tex, is_vertex=True, IDs_to_labels=ids)
    got, got_id = tmesh.label_ground_class(survey["slope_file"], **kw)
    want, want_id = jmesh.label_ground_class(survey["slope_file"], **kw)
    np.testing.assert_array_equal(got, want)
    assert got_id == want_id
    if case in ("texture", "named"):
        np.testing.assert_array_equal(tmesh.vertex_texture, jmesh.vertex_texture)
        assert tmesh.IDs_to_labels == jmesh.IDs_to_labels
    assert (got == got_id).any()


def test_tif_texture_and_face_area_ratios_match_jax(survey):
    tmesh, jmesh = meshes(survey)
    tmesh.load_texture(survey["slope_file"])
    jmesh.load_texture(survey["slope_file"])
    np.testing.assert_array_equal(tmesh.vertex_texture, jmesh.vertex_texture)
    got, want = tmesh.get_face_area_ratios(), jmesh.get_face_area_ratios()
    np.testing.assert_array_equal(got, want)
    assert got.min() < 0.01 and got.max() > 0.99  # box walls and the ground


def _agree(folder_a, folder_b, names):
    same = total = 0
    for name in names:
        a, b = read_image_or_numpy(folder_a / name), read_image_or_numpy(folder_b / name)
        assert a.shape == b.shape and a.dtype == b.dtype
        same += int((a == b).sum()) if a.dtype == np.uint8 else int(
            (np.isclose(a, b, rtol=1e-6, atol=0) | (np.isnan(a) & np.isnan(b))).sum())
        total += a.size
    return same / total


def _pix2face_both(survey):
    """Each package's pix2face of the survey's 4 views, as its entry points
    render them (the JAX package's default raster configuration)."""
    from geograypher_tpu.cameras.metashape import MetashapeCameraSet as JaxCameras
    from geograypher_tpu_torch.cameras.metashape import MetashapeCameraSet

    tmesh = TexturedMesh(survey["mesh_file"], transform_filename=survey["cameras_file"],
                         device="cpu")
    jmesh = JaxTexturedMesh(survey["mesh_file"], transform_filename=survey["cameras_file"])
    got = tmesh.pix2face(MetashapeCameraSet(survey["cameras_file"], survey["image_folder"]))
    want = jmesh.pix2face(JaxCameras(survey["cameras_file"], survey["image_folder"]))
    return got, want


@pytest.mark.parametrize("binary", [True, False])
def test_render_height_masks_matches_jax(survey, tmp_path, binary):
    """uint8 masks {0, 1, 2, 255} (ground, low, canopy, unseen) and float
    renders (NaN unseen): equal to the JAX package's on every pixel where
    the two rasters see the same face; elsewhere the rasters swap faces on
    knife edges (ROADMAP C4: 1.7% of this survey's pixels)."""
    kw = dict(mesh_file=survey["mesh_file"], cameras_file=survey["cameras_file"],
              image_folder=survey["image_folder"], DTM_file=survey["slope_file"],
              ground_threshold=0.5, canopy_threshold=2.0, binary_masks=binary)
    mesh = render_height_masks(render_savefolder=tmp_path / "t", device="cpu", **kw)
    jax_height_masks(render_savefolder=tmp_path / "j", **kw)
    ext = ".png" if binary else ".npy"
    names = [f"img_{k:04d}{ext}" for k in range(4)]
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == names
    p2f, jp2f = _pix2face_both(survey)
    for k, name in enumerate(names):
        a = read_image_or_numpy(tmp_path / "t" / name)
        b = read_image_or_numpy(tmp_path / "j" / name)
        assert a.shape == b.shape == p2f[k].shape and a.dtype == b.dtype
        knife_edge(p2f[k], jp2f[k], min_agree=0.98)
        same = p2f[k] == jp2f[k]
        np.testing.assert_array_equal(a[same], b[same])
    first = read_image_or_numpy(tmp_path / "t" / names[0])
    if binary:
        assert first.dtype == np.uint8 and set(np.unique(first)) <= {0, 1, 2, 255}
        assert len(np.unique(first)) >= 3
    else:
        assert first.dtype == np.float32 and np.isfinite(first).mean() > 0.5
    assert mesh.vertex_texture.shape == (mesh.n_verts, 1)


def test_aggregate_images_with_dtm_matches_jax(survey):
    """Labels aggregated, faces -> vertices -> ground relabel -> faces: the
    predicted classes (ground = the next id after the named ones) agree on
    >= 99% of faces with the JAX package's, and ground faces exist."""
    ids = {0: "soil", 1: "obj_1", 2: "obj_2", 3: "obj_3"}
    kw = dict(mesh_file=survey["mesh_file"], cameras_file=survey["cameras_file"],
              image_folder=survey["image_folder"], label_folder=survey["label_folder"],
              take_every_nth_camera=None, n_classes=survey["n_classes"],
              DTM_file=survey["slope_file"], height_above_ground_threshold=1.0,
              IDs_to_labels=ids)
    pred, avg = aggregate_images(device="cpu", **kw)
    jpred, javg = jax_aggregate(**kw)
    assert pred.shape == jpred.shape and avg.shape == javg.shape
    same = (pred == jpred) | (np.isnan(pred) & np.isnan(jpred))
    assert same.mean() >= 0.99
    assert (pred == len(ids)).sum() > 0.2 * np.isfinite(pred).sum()
    # without names the ground class is NaN: those faces end unlabelled
    pred_nan, _ = aggregate_images(device="cpu", **{**kw, "IDs_to_labels": None})
    assert np.isnan(pred_nan).sum() > np.isnan(pred).sum()


@pytest.mark.parametrize("render_ground", [False, True])
def test_render_labels_with_dtm_matches_jax(survey, tmp_path, render_ground):
    """The vector texture, its labelled vertices near the ground relabelled
    (rendered as a class of its own, or left unlabelled)."""
    kw = dict(mesh_file=survey["mesh_file"], cameras_file=survey["cameras_file"],
              image_folder=survey["image_folder"], texture=survey["labels_vector_file"],
              texture_column_name="species", DTM_file=survey["slope_file"],
              ground_height_threshold=1.5, render_ground_class=render_ground,
              ROI_buffer_radius_meters=100.0)  # the whole scene: crops equal
    mesh, _ = render_labels(render_savefolder=tmp_path / "t", device="cpu",
                                        **kw)
    jmesh, _ = jax_render_labels(render_savefolder=tmp_path / "j", **kw)
    names = [f"img_{k:04d}.png" for k in range(4)]
    assert _agree(tmp_path / "t", tmp_path / "j", names) >= 0.99
    assert mesh.IDs_to_labels == jmesh.IDs_to_labels
    tex = mesh.vertex_texture[:, 0]
    if render_ground:
        assert "ground" in mesh.IDs_to_labels.values()
    else:
        assert "ground" not in mesh.IDs_to_labels.values()
    np.testing.assert_array_equal(tex, jmesh.vertex_texture[:, 0])


def _jax_ortho(self, crs=None, resolution_m=0.2, max_pixels=8192,
               max_total_pixels=2 ** 28, config=None, stats=None):
    """The port's mesh rendered by the JAX package's ``ortho_pix2face``."""
    jmesh = JaxTexturedMesh((self.verts, self.faces), CRS=self.CRS, raster_config=XLA)
    return jmesh.ortho_pix2face(crs, resolution_m, max_pixels, max_total_pixels)


@pytest.mark.parametrize("aggregated", ["classes", "fractions"])
@pytest.mark.parametrize("dtm", [False, True])
@pytest.mark.parametrize("same_raster", [True, False])
def test_label_polygons_entry_point_matches_jax(survey, tmp_path, monkeypatch, dtm,
                                                aggregated, same_raster):
    """Per-face classes or (F, C) fractions (argmax, NaN rows unseen), the
    DTM's ground faces down-weighted or not: the labels written are the
    JAX package's, through the same pix2face and on each package's own."""
    labels = np.asarray(survey["face_labels"], float)
    if aggregated == "classes":
        values = labels.copy()
        values[::9] = np.nan
        classes = values
    else:
        values = np.eye(survey["n_classes"])[survey["face_labels"]] * 0.8
        values[::9] = np.nan
        # the JAX entry point's own argmax of a 2-D file writes into a
        # read-only array (ROADMAP C4): it gets the classes it would make
        classes = np.array(find_argmax_nonzero_value(
            jnp.asarray(np.nan_to_num(values), jnp.float32)))
        classes[~np.isfinite(values).any(axis=1)] = np.nan
    np.save(tmp_path / "agg.npy", values)
    np.save(tmp_path / "classes.npy", classes)
    if same_raster:
        monkeypatch.setattr(TexturedMesh, "ortho_pix2face", _jax_ortho)
    kw = dict(mesh_file=survey["mesh_file"], mesh_CRS=None,
              geospatial_polygons_to_label=survey["labels_vector_file"],
              transform_filename=survey["cameras_file"],
              IDs_to_labels={0: "ground", 1: "a", 2: "b", 3: "c"},
              DTM_file=survey["slope_file"] if dtm else None,
              height_above_ground_threshold=1.0, ground_voting_weight=0.01)
    got = label_polygons(aggregated_face_values_file=tmp_path / "agg.npy",
                         geospatial_polygons_labeled_savefile=tmp_path / "t.json",
                         device="cpu", **kw)
    want = jax_label_polygons(aggregated_face_values_file=tmp_path / "classes.npy",
                              geospatial_polygons_labeled_savefile=tmp_path / "j.json", **kw)
    assert got == want and len(got) == 3
    written = json.loads((tmp_path / "t.json").read_text())
    assert [f["properties"]["predicted_labels"] for f in written["features"]] == got
    assert set(got) <= {"a", "b", "c", "ground"}


def test_entry_points_are_exported():
    assert {"render_height_masks", "label_polygons"} <= set(entrypoints.__all__)
