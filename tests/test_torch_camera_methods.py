"""The port's camera-set methods, geometric and CRS helpers,
``rasterize_batch``, the segmentor-subset method and the concept figure's
generators against the JAX package on the same numpy-seeded inputs; and
an AST comparison of the two packages' public names."""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geograypher_tpu.cameras.core import CameraSet as JaxCameraSet
from geograypher_tpu.cameras.metashape import MetashapeCameraSet as JaxMetashape
from geograypher_tpu.cameras.segmentor_set import (
    SegmentorCameraSet as JaxSegmentorCameraSet,
)
from geograypher_tpu.ops import rasterize as jr
from geograypher_tpu.predictors.segmentors import LookUpSegmentor as JaxLookUp
from geograypher_tpu.utils import crs as jcrs
from geograypher_tpu.utils import example_data as jex
from geograypher_tpu.utils import fixtures as jf
from geograypher_tpu.utils import geometric as jg
from geograypher_tpu_torch.cameras.core import CameraSet, make_camera_batch
from geograypher_tpu_torch.cameras.metashape import MetashapeCameraSet
from geograypher_tpu_torch.cameras.segmentor_set import SegmentorCameraSet
from geograypher_tpu_torch.ops import rasterize as tr
from geograypher_tpu_torch.predictors.segmentors import LookUpSegmentor
from geograypher_tpu_torch.utils import crs as tcrs
from geograypher_tpu_torch.utils import example_data as tex
from geograypher_tpu_torch.utils import fixtures as tfx
from geograypher_tpu_torch.utils import geometric as tg
from geograypher_tpu_torch.utils.io import write_image
from tests.test_torch_rasterize import knife_edge, one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]

# Public names of the JAX package that have no counterpart in the port, by
# design (ROADMAP A, "Not to port"): the TPU kernels, whose counterparts are
# the CUDA kernels of csrc/ under their own names, and the TPU plumbing.
NOT_PORTED = {
    # the native C++ library: its RLE codec is numpy in utils/cache.py and
    # its PLY reader is utils/meshio.py
    "native/__init__.py": {"class_counts_host", "fastply", "fastply.load_ply",
                           "get_lib", "rle_decode", "rle_encode"},
    # B2-B4 and the fold windows: csrc/face_class_counts.cu
    "ops/agg_tiled.py": {"entry_occupancy", "face_counts_from_tiles",
                         "fold_tile_counts", "fold_tile_counts_grouped",
                         "fold_window_overflow", "level_fold_windows",
                         "tile_class_counts"},
    # B1: csrc/raster_tiles.cu
    "ops/pallas_raster.py": {"raster_tiles_pallas"},
    "ops/rasterize.py": {"fused_counts_pallas", "l0_face_ids", "l0_geometry",
                         "probe_fold_window", "probe_subtile_census",
                         "size_subtile_caps"},
    # B5, B6 and the S slab layout: csrc/s_raster.cu and one counts launch
    "ops/subtile.py": {"image_to_subtile", "prep_s_slab", "s_count_pallas",
                       "s_entry_ids", "s_raster_pallas", "subtile_to_image"},
    # the planner's compiled group programs
    "parallel/planner.py": {"clear_program_caches"},
    "parallel/sharding.py": {"unrolled_view_scan"},
    # remap_image_torch is its counterpart (tests/test_torch_render.py)
    "cameras/distortion.py": {"remap_image_jax"},
}


def public_names(root: Path, imported: bool = False) -> dict:
    """{module path: public top-level defs and classes and public methods
    as ``Class.method``; with ``imported``, also the names a module
    imports from another (a counterpart may live there)}."""
    out = {}
    for f in sorted(root.rglob("*.py")):
        tree = ast.parse(f.read_text())
        names = set()
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                names.add(node.name)
                if isinstance(node, ast.ClassDef):
                    names |= {f"{node.name}.{m.name}" for m in node.body
                              if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}
            elif imported and isinstance(node, ast.ImportFrom):
                names |= {a.asname or a.name for a in node.names}
        out[f.relative_to(root).as_posix()] = {
            n for n in names if not n.split(".")[-1].startswith("_")}
    return out


def test_every_public_name_has_a_counterpart():
    jax_names = public_names(ROOT / "geograypher_tpu")
    port_names = public_names(ROOT / "geograypher_tpu_torch", imported=True)
    missing = {}
    for module, names in jax_names.items():
        gap = names - port_names.get(module, set()) - NOT_PORTED.get(module, set())
        if gap:
            missing[module] = sorted(gap)
    assert not missing, missing
    # the written list names only what the JAX package has and the port lacks
    for module, names in NOT_PORTED.items():
        assert names <= jax_names[module], (module, names - jax_names[module])
        assert not names & port_names.get(module, set()), module


def test_no_roadmap_item_raises_in_the_port():
    sources = sorted((ROOT / "geograypher_tpu_torch").rglob("*.py"))
    raising = [f"{f.relative_to(ROOT)}:{i}"
               for f in sources
               for i, line in enumerate(f.read_text().splitlines(), 1)
               if "NotImplementedError" in line and "ROADMAP" in line]
    assert not raising, raising


# -- geometric and CRS helpers ------------------------------------------------


def test_geometric_helpers_match_jax():
    rng = np.random.default_rng(0)
    v, e1, e2 = (rng.normal(size=(50, 3)) for _ in range(3))
    t = np.eye(4)
    t[:3, :3] = 2.5 * np.linalg.qr(rng.normal(size=(3, 3)))[0]
    assert tg.get_scale_from_transform(t) == jg.get_scale_from_transform(t)
    assert tg.get_scale_from_transform(None) == jg.get_scale_from_transform(None)
    np.testing.assert_array_equal(tg.angle_between(v, e1), jg.angle_between(v, e1))
    np.testing.assert_array_equal(tg.orthogonal_projection(v, e1),
                                  jg.orthogonal_projection(v, e1))
    np.testing.assert_array_equal(tg.projection_onto_plane(v, e1),
                                  jg.projection_onto_plane(v, e1))
    np.testing.assert_array_equal(tg.projection_onto_spanned_plane(v, e1, e2),
                                  jg.projection_onto_spanned_plane(v, e1, e2))


@pytest.mark.parametrize("epsg_in, epsg_out", [(4326, 4978), (4978, 32611), (32611, 4326)])
def test_crs_helpers_match_jax(epsg_in, epsg_out):
    rng = np.random.default_rng(1)
    lla = np.stack([36 + rng.random(20), -119 + rng.random(20), 100 * rng.random(20)], 1)
    pts = jcrs.transform_points(lla, 4326, epsg_in)
    np.testing.assert_array_equal(tcrs.convert_CRS_3D_points(pts, epsg_in, epsg_out),
                                  jcrs.convert_CRS_3D_points(pts, epsg_in, epsg_out))
    for epsg in (epsg_in, epsg_out):
        assert tcrs.crs_is_geocentric(epsg) == jcrs.crs_is_geocentric(epsg)


# -- camera-set methods --------------------------------------------------------


@pytest.fixture(scope="module")
def survey_xml(tmp_path_factory):
    """A georeferenced Metashape export of 6 cameras of two sensors: nadir
    and oblique, seeded."""
    folder = tmp_path_factory.mktemp("methods")
    rng = np.random.default_rng(2)
    c2ws = [jf.nadir_camera(4.0, 60.0, 96)] + [
        jf.oblique_camera(4.0, 60.0, 96, pitch_deg=float(p), azimuth_deg=float(a))
        for p, a in zip(rng.uniform(10, 40, 5), rng.uniform(0, 360, 5))]
    sensors = [dict(f=60.0), dict(f=70.0, cx=1.5)]
    xml = tex.make_metashape_xml(
        c2ws, [f"img_{k}.png" for k in range(6)], tex.local_to_ecef_frame(36.0, -119.0),
        60.0, 96, 64, sensors=sensors, sensor_ids=[0, 1, 0, 1, 0, 0])
    path = folder / "cameras.xml"
    path.write_text(xml)
    return path


def test_view_angles_and_sensor_groups_match_jax(survey_xml):
    ours = MetashapeCameraSet(survey_xml, survey_xml.parent)
    theirs = JaxMetashape(survey_xml, survey_xml.parent)
    angles = ours.get_camera_view_angles()
    np.testing.assert_allclose(angles, theirs.get_camera_view_angles(), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(ours.get_camera_view_angles([1, 3], in_deg=False),
                               theirs.get_camera_view_angles([1, 3], in_deg=False),
                               rtol=0, atol=1e-11)
    assert angles[0, 0] < 1 and (angles[1:, 0] > 5).all()  # nadir, obliques
    assert ours.n_image_channels() == theirs.n_image_channels() == 3
    sizes = {0: {"f": 10.0, "image_width": 8, "image_height": 6},
             1: {"f": 10.0, "image_width": 6, "image_height": 6},
             2: {"f": 12.0, "image_width": 8, "image_height": 6}}
    ids = [0, 1, 2, 1, 0]
    groups = CameraSet([np.eye(4)] * 5, sizes, sensor_IDs=ids).sensor_groups()
    assert groups == JaxCameraSet([np.eye(4)] * 5, sizes, sensor_IDs=ids).sensor_groups()
    assert groups == {(8, 6): [0, 2, 4], (6, 6): [1, 3]}
    with pytest.raises(ValueError):
        CameraSet([np.eye(4)]).get_camera_view_angles()


def test_camera_batch_properties():
    c2w = np.stack([jf.nadir_camera(4.0, 60.0, 96), jf.oblique_camera(4.0, 60.0, 96)])
    batch = make_camera_batch(c2w, [60.0, 60.0], 0.0, 0.0, 96, 64, device="cpu")
    assert batch.n_cameras == 2
    assert isinstance(batch.positions, torch.Tensor)
    assert batch.positions.device == batch.cam_to_world.device
    np.testing.assert_array_equal(batch.positions.numpy(),
                                  c2w[:, :3, 3].astype(np.float32))


@pytest.mark.parametrize("copy", [True, False])
def test_export_images_matches_jax(tmp_path, copy):
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.jpg").write_bytes(b"x")
    (src / "b.png").write_bytes(b"yy")
    sensor = {0: {"f": 10.0, "cx": 0, "cy": 0, "image_width": 4, "image_height": 4}}
    files = [src / "a.jpg", src / "b.png", src / "missing.png"]
    for cls, out in ((CameraSet, tmp_path / "port"), (JaxCameraSet, tmp_path / "jax")):
        cams = cls([np.eye(4)] * 3, sensor, image_filenames=files)
        if copy:
            cams.export_images(out, copy=True)
        else:
            cams.get_subset_cameras([0, 1]).export_images(out)
    listing = {p.name: (p.is_symlink(), p.read_bytes())
               for p in sorted((tmp_path / "port").iterdir())}
    assert listing == {p.name: (p.is_symlink(), p.read_bytes())
                       for p in sorted((tmp_path / "jax").iterdir())}
    assert listing["a.jpg"] == (not copy, b"x")


def test_segmentor_subset_matches_jax(tmp_path):
    """Views whose label file is missing, or does not decode, are dropped,
    as the JAX package drops them; a device fault propagates."""
    labels = tmp_path / "labels"
    sensor = {0: {"f": 10.0, "cx": 0, "cy": 0, "image_width": 8, "image_height": 6}}
    rng = np.random.default_rng(3)
    for k in (0, 2):
        write_image(labels / f"v{k}.png", rng.integers(0, 3, (6, 8), dtype=np.uint8))
    (labels / "v3.png").write_bytes(b"not a png")
    files = [tmp_path / f"v{k}.png" for k in range(4)]
    ours = SegmentorCameraSet(CameraSet([np.eye(4)] * 4, sensor, image_filenames=files),
                              LookUpSegmentor(tmp_path, labels, num_classes=3))
    theirs = JaxSegmentorCameraSet(
        JaxCameraSet([np.eye(4)] * 4, sensor, image_filenames=files),
        JaxLookUp(tmp_path, labels, num_classes=3))
    sub = ours.get_subset_with_valid_segmentation()
    assert sub.image_filenames == theirs.get_subset_with_valid_segmentation().image_filenames
    assert [f.name for f in sub.image_filenames] == ["v0.png", "v2.png"]
    assert ours.n_image_channels() == theirs.n_image_channels() == 3

    class DeviceFault:
        num_classes = 3

        def segment_image(self, *args, **kwargs):
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

    faulty = SegmentorCameraSet(CameraSet([np.eye(4)], sensor, image_filenames=files[:1]),
                                DeviceFault())
    with pytest.raises(RuntimeError, match="CUDA"):
        faulty.get_subset_with_valid_segmentation()


# -- rasterize_batch -------------------------------------------------------------


def batch_scene():
    verts, faces = jf.make_grid_mesh(
        n=21, size=4.0, z_fn=lambda x, y: 0.2 * np.sin(3 * x) * np.cos(2 * y))
    tri = jf.gather_tri_verts(verts, faces).astype(np.float32)
    c2ws = [jf.nadir_camera(4.0, 50.0, 100),
            jf.oblique_camera(4.0, 60.0, 100, pitch_deg=30.0, azimuth_deg=40.0),
            jf.oblique_camera(3.0, 45.0, 100, pitch_deg=15.0, azimuth_deg=200.0)]
    c2ws[0][2, 3] *= 1.6  # farther: the mesh leaves background in view
    w2c = np.stack([np.linalg.inv(c) for c in c2ws]).astype(np.float32)
    return tri, w2c, np.array([50.0, 60.0, 45.0], np.float32)


def test_rasterize_batch_matches_jax():
    """The port's batch against the JAX batch (XLA raster) under the
    knife-edge contract, and view for view equal to the port's own
    ``rasterize_triangles``."""
    tri, w2c, fs = batch_scene()
    caps = (256, 64, 32, 32)
    got = tr.rasterize_batch(torch.as_tensor(tri), torch.as_tensor(w2c),
                             torch.as_tensor(fs), 100, 80, tr.RasterConfig(caps=caps))
    want = np.asarray(jr.rasterize_batch(
        jnp.asarray(tri), jnp.asarray(w2c), jnp.asarray(fs), image_w=100, image_h=80,
        config=jr.RasterConfig(caps=caps, backend="xla")))
    assert got.shape == (3, 80, 100) and got.dtype == torch.int32
    got = got.numpy()
    for i in range(3):
        knife_edge(got[i], want[i])
        cam = tr.transform_to_camera(torch.as_tensor(tri), torch.as_tensor(w2c[i]))
        one = tr.rasterize_triangles(cam, float(fs[i]), 100, 80,
                                     tr.RasterConfig(caps=caps))
        np.testing.assert_array_equal(got[i], one.numpy())
    assert (got[0] < 0).any() and (got >= 0).any()


def test_rasterize_batch_raises_naming_the_views():
    tri, w2c, fs = batch_scene()
    with pytest.raises(ValueError, match=r"views \[0, 1, 2\]"):
        tr.rasterize_batch(torch.as_tensor(tri), torch.as_tensor(w2c),
                           torch.as_tensor(fs), 100, 80, tr.RasterConfig(caps=(1, 1, 1, 1)))


# -- fixtures and the concept figure's generators ------------------------------------


@pytest.mark.parametrize("kwargs", [dict(n_points=500, seed=3),
                                    dict(n_points=900, size=2.0, seed=7, jitter=0.3,
                                         extra_frac=0.0,
                                         z_fn=lambda x, y: 0.1 * np.sin(x + y))])
def test_make_irregular_mesh_matches_jax(kwargs):
    for got, want in zip(tfx.make_irregular_mesh(**kwargs),
                         jf.make_irregular_mesh(**kwargs)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_scene_generators_match_jax():
    np.testing.assert_array_equal(tex.create_non_overlapping_points(12, 1.5, 10.0, 4),
                                  jex.create_non_overlapping_points(12, 1.5, 10.0, 4))
    kwargs = dict(box_centers=[(-3, 2), (4, 4)], cylinder_centers=[(0, -3)],
                  cone_centers=[(3, -2), (-4, -4)], ground_resolution=20)
    got, want = tex.create_scene_mesh(**kwargs), jex.create_scene_mesh(**kwargs)
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert list(got[3]["name"]) == list(want[3]["name"])
    for pa, pb in zip(got[3].geometries, want[3].geometries):
        np.testing.assert_array_equal(pa.exterior, pb.exterior)
