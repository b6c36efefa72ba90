"""The geometry and texture side of the port's ``TexturedMesh`` and the
camera-set helpers of the render path against the JAX package, on the
synthetic survey on disk (CPU): textures from arrays, files, mesh scalars
and vector files, vertex <-> face conversion, ROI cropping, downsampling,
hashes and export."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geograypher_tpu.cameras.metashape import MetashapeCameraSet as JaxMetashape
from geograypher_tpu.meshes.mesh import TexturedMesh as JaxTexturedMesh
from geograypher_tpu.ops import aggregate as ja
from geograypher_tpu.utils import vector as jvector
from geograypher_tpu.utils.example_data import create_example_survey
from geograypher_tpu_torch import interop
from geograypher_tpu_torch.cameras import core as tcore
from geograypher_tpu_torch.cameras.metashape import MetashapeCameraSet
from geograypher_tpu_torch.meshes.mesh import TexturedMesh
from geograypher_tpu_torch.ops import aggregate as ta
from geograypher_tpu_torch.utils import vector as tvector
from geograypher_tpu_torch.utils.meshio import load_mesh
from tests.test_torch_rasterize import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def survey(tmp_path_factory):
    return create_example_survey(tmp_path_factory.mktemp("survey"),
                                 write_label_images=False)


def both(survey, **kw):
    """(JAX mesh, port mesh) loaded from the survey's files."""
    args = dict(transform_filename=survey["cameras_file"], **kw)
    return (JaxTexturedMesh(survey["mesh_file"], **args),
            TexturedMesh(survey["mesh_file"], device="cpu", **args))


def same_mesh(jmesh, mesh):
    np.testing.assert_array_equal(mesh.verts, jmesh.verts)
    np.testing.assert_array_equal(mesh.faces, jmesh.faces)
    assert mesh.faces.dtype == jmesh.faces.dtype and mesh.CRS == jmesh.CRS
    assert mesh.get_mesh_hash() == jmesh.get_mesh_hash()
    for name in ("vertex_texture", "face_texture"):
        a, b = getattr(mesh, name), getattr(jmesh, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert mesh.IDs_to_labels == jmesh.IDs_to_labels


def test_load_and_hashes_match_jax(survey):
    jmesh, mesh = both(survey)
    same_mesh(jmesh, mesh)
    np.testing.assert_array_equal(mesh._local_transform, jmesh._local_transform)
    assert mesh.get_working_projected_CRS() == survey["utm_epsg"]
    jcams = JaxMetashape(survey["cameras_file"], survey["image_folder"])
    cams = MetashapeCameraSet(survey["cameras_file"], survey["image_folder"])
    assert cams.get_camera_hash() == jcams.get_camera_hash()
    assert cams.get_camera_hash(True) == jcams.get_camera_hash(True)
    assert cams[1].get_camera_hash() == jcams[1].get_camera_hash()
    assert cams[1:3].get_camera_hash() == jcams[1:3].get_camera_hash()
    assert cams[0].get_camera_hash() != cams[1].get_camera_hash()
    # a distortion coefficient changes the digest, as in the JAX package
    for s in (cams, jcams):
        s.sensors[0]["distortion_params"] = {"k1": np.float64(0.01)}
    assert cams.get_camera_hash() == jcams.get_camera_hash()
    np.testing.assert_array_equal(cams.get_camera_locations(),
                                  jcams.get_camera_locations())
    cams.lon_lats = [None] * len(cams)
    jcams.lon_lats = [None] * len(jcams)
    np.testing.assert_array_equal(np.array(cams.get_lon_lat_coords()),
                                  np.array(jcams.get_lon_lat_coords()))
    assert cams.find_missing_images() == jcams.find_missing_images()
    assert len(cams.find_missing_images()) == 4
    vec = tcore.distortion_dict_to_vector({"k1": 0.1, "p2": -0.2})
    assert tcore.distortion_vector_to_dict(vec) == {"k1": 0.1, "p2": -0.2}


def test_vector_texture_matches_jax(survey):
    """Vertex labels from polygon containment, the class table, and the
    face texture voted from them."""
    kw = dict(texture=survey["labels_vector_file"], texture_column_name="species")
    jmesh, mesh = both(survey, **kw)
    same_mesh(jmesh, mesh)
    assert mesh.IDs_to_labels == {0: "object_1", 1: "object_2", 2: "object_3"}
    assert np.isfinite(mesh.vertex_texture).any() and np.isnan(mesh.vertex_texture).any()
    np.testing.assert_array_equal(mesh.get_texture(False), jmesh.get_texture(False))
    np.testing.assert_array_equal(mesh.get_texture(True), jmesh.get_texture(True))
    assert mesh.get_texture(False, try_verts_faces_conversion=False) is None
    # without a column: the polygon's index
    ids, table = mesh.get_values_for_verts_from_vector(survey["labels_vector_file"])
    jids, jtable = jmesh.get_values_for_verts_from_vector(survey["labels_vector_file"])
    np.testing.assert_array_equal(ids, jids)
    assert table == jtable
    # the same file as GeoPackage, read by the port
    gpkg = survey["labels_vector_file"].with_suffix(".gpkg")
    tvector.VectorData.read_file(survey["labels_vector_file"]).to_file(gpkg)
    np.testing.assert_array_equal(
        mesh.get_values_for_verts_from_vector(gpkg, "species")[0],
        jmesh.vertex_texture[:, 0])
    pts, jpts = mesh.get_verts_vector(), jmesh.get_verts_vector()
    assert pts.epsg == jpts.epsg and len(pts) == mesh.n_verts
    np.testing.assert_array_equal(np.stack(pts.geometries), np.stack(jpts.geometries))


def test_texture_sources(survey, tmp_path):
    """Arrays (per vertex, per face), a .npy file, a named scalar of the
    mesh file, another mesh, a raster file sampled at the vertices."""
    jmesh, mesh = both(survey)
    rng = np.random.default_rng(0)
    per_face = rng.integers(0, 4, mesh.n_faces).astype(float)
    per_vert = rng.random((mesh.n_verts, 3))
    for tex in (per_face, per_vert):
        mesh.load_texture(tex)
        jmesh.load_texture(tex)
        same_mesh(jmesh, mesh)
    np.save(tmp_path / "tex.npy", per_face)
    _, from_file = both(survey, texture=tmp_path / "tex.npy")
    np.testing.assert_array_equal(from_file.face_texture[:, 0], per_face)
    with pytest.raises(ValueError, match="matches neither"):
        mesh.set_texture(np.zeros(7))
    # a per-vertex scalar stored in the mesh file
    np.savez(tmp_path / "m.npz", verts=mesh.verts, faces=mesh.faces,
             height=mesh.verts[:, 2])
    named = TexturedMesh(tmp_path / "m.npz", texture="height", device="cpu")
    jnamed = JaxTexturedMesh(tmp_path / "m.npz", texture="height")
    same_mesh(jnamed, named)
    np.testing.assert_array_equal(named.vertex_texture[:, 0], mesh.verts[:, 2])
    carried = interop.mesh_from_jax(jnamed, device="cpu")
    np.testing.assert_array_equal(carried._mesh_attrs["height"], mesh.verts[:, 2])
    carried = interop.mesh_from_jax(jmesh, device="cpu")
    np.testing.assert_array_equal(carried._local_transform, jmesh._local_transform)
    # another mesh shares its geometry
    shared = TexturedMesh(mesh, texture=per_face, device="cpu")
    assert shared.verts is mesh.verts and shared.CRS == mesh.CRS
    np.testing.assert_array_equal(shared._local_transform, mesh._local_transform)
    # a raster texture (ported since A6): sampled at every vertex, as the
    # JAX package samples it (more in tests/test_torch_dtm.py)
    from geograypher_tpu_torch.utils.raster import Raster, write_geotiff

    x0, y0 = mesh.verts[:, 0].min() - 1, mesh.verts[:, 1].max() + 1
    write_geotiff(tmp_path / "r.tif", Raster(
        np.arange(400, dtype=np.float32).reshape(20, 20), (0.5, 0, x0, 0, -0.5, y0)))
    mesh.load_texture(tmp_path / "r.tif")
    jmesh.load_texture(tmp_path / "r.tif")
    np.testing.assert_array_equal(mesh.vertex_texture, jmesh.vertex_texture)
    assert np.isfinite(mesh.vertex_texture).any()
    with pytest.raises(ValueError, match="Cannot load texture"):
        mesh.load_texture("labels.txt")


def test_vert_face_conversions_match_jax():
    rng = np.random.default_rng(1)
    n_verts, n_faces = 60, 150
    faces = rng.integers(0, n_verts, (n_faces, 3)).astype(np.int32)
    labels = rng.integers(0, 5, n_verts).astype(np.float32)
    labels[rng.random(n_verts) < 0.3] = np.nan
    got = ta.vert_to_face_discrete(torch.as_tensor(faces), torch.as_tensor(labels), 5)
    want = np.asarray(ja.vert_to_face_discrete(jnp.asarray(faces), jnp.asarray(labels), 5))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isnan(want).any() and np.isfinite(want).any()
    # a three-way tie goes to the lowest class id
    tie = ta.vert_to_face_discrete(torch.tensor([[0, 1, 2]]),
                                   torch.tensor([3.0, 1.0, 2.0]), 4)
    assert tie.item() == 1.0
    vals = rng.random((n_verts, 2)).astype(np.float32)
    vals[rng.random(n_verts) < 0.2] = np.nan
    np.testing.assert_array_equal(
        ta.vert_to_face_mean(torch.as_tensor(faces), torch.as_tensor(vals)).numpy(),
        np.asarray(ja.vert_to_face_mean(jnp.asarray(faces), jnp.asarray(vals))))
    np.testing.assert_array_equal(
        ta.vert_to_face_mean(torch.as_tensor(faces), torch.as_tensor(vals[:, 0])).numpy(),
        np.asarray(ja.vert_to_face_mean(jnp.asarray(faces), jnp.asarray(vals[:, 0]))))
    face_vals = rng.random((n_faces, 3)).astype(np.float32)
    face_vals[rng.random(n_faces) < 0.2] = np.nan
    for fv in (face_vals, face_vals[:, 0]):
        np.testing.assert_allclose(
            ta.face_to_vert_texture(torch.as_tensor(faces), torch.as_tensor(fv),
                                    n_verts).numpy(),
            np.asarray(ja.face_to_vert_texture(jnp.asarray(faces), jnp.asarray(fv),
                                               n_verts)),
            rtol=1e-6, equal_nan=True)


def test_get_and_remap_texture_match_jax(survey):
    jmesh, mesh = both(survey)
    rng = np.random.default_rng(2)
    discrete = rng.integers(0, 3, mesh.n_verts).astype(float)
    discrete[rng.random(mesh.n_verts) < 0.2] = np.nan
    continuous = rng.random((mesh.n_verts, 2))
    for tex in (discrete, continuous):
        for m in (mesh, jmesh):
            m.set_texture(tex)
        assert mesh.is_discrete_texture(mesh.vertex_texture) == (tex is discrete)
        np.testing.assert_array_equal(mesh.get_texture(), jmesh.get_texture())
        np.testing.assert_array_equal(mesh.get_texture(False), jmesh.get_texture(False))
        np.testing.assert_array_equal(mesh.vert_to_face_texture(),
                                      jmesh.vert_to_face_texture())
    per_face = rng.random(mesh.n_faces)
    for m in (mesh, jmesh):
        m.set_texture(per_face)
    np.testing.assert_allclose(mesh.get_texture(True), jmesh.get_texture(True),
                               rtol=1e-6, equal_nan=True)
    assert mesh.get_texture(True, try_verts_faces_conversion=False) is None
    with pytest.raises(ValueError, match="No vertex texture"):
        mesh.vert_to_face_texture()
    for m in (mesh, jmesh):
        m.set_texture(discrete, IDs_to_labels={0: "oak", 1: "pine", 2: "fir"})
        m.remap_texture({"pine": 7, "oak": 4})
    same_mesh(jmesh, mesh)
    assert set(np.unique(mesh.vertex_texture[np.isfinite(mesh.vertex_texture)])) == {4, 7}
    for m in (mesh, jmesh):
        m.remap_texture({4.0: 0, 7.0: 1})
    same_mesh(jmesh, mesh)
    mesh.IDs_to_labels = None
    with pytest.raises(ValueError, match="IDs_to_labels"):
        mesh.remap_texture({"oak": 1})


def test_keep_faces_and_downsample_match_jax(survey):
    kw = dict(texture=survey["labels_vector_file"], texture_column_name="species")
    jmesh, mesh = both(survey, **kw)
    mask = np.random.default_rng(3).random(mesh.n_faces) < 0.4
    (jsub, jmask), (sub, got_mask) = jmesh._keep_faces(mask, False), mesh._keep_faces(mask, False)
    same_mesh(jsub, sub)
    np.testing.assert_array_equal(got_mask, jmask)
    assert sub.device == mesh.device and sub.n_faces == mask.sum() < mesh.n_faces
    np.testing.assert_array_equal(sub._local_transform, mesh._local_transform)
    same_mesh(jmesh.downsample(0.3), mesh.downsample(0.3))
    jsmall, small = both(survey, downsample_target=0.3, **kw)
    same_mesh(jsmall, small)
    assert small.n_faces < mesh.n_faces and small.vertex_texture.shape[0] == small.n_verts
    # in place, with the device caches of the old geometry dropped
    mesh.get_tri_verts_device(None)
    mesh._keep_faces(mask, inplace=True)
    jmesh._keep_faces(mask, inplace=True)
    same_mesh(jmesh, mesh)
    assert not mesh._tri_cache
    order, jorder = mesh.spatial_sort_faces(), jmesh.spatial_sort_faces()
    np.testing.assert_array_equal(order, jorder)
    same_mesh(jmesh, mesh)


def _far_from_buffer_edge(polys, pts, dist, epsg_bounds_pad):
    """Points whose signed distance to the polygons is clear of ``dist``
    by the raster buffer's tolerance (see
    tests/test_torch_io.py::test_points_near_polygons_against_the_raster_buffer)."""
    bs = np.asarray([p.bounds for p in polys])
    sides = (bs[:, 2].max() - bs[:, 0].min() + 2 * epsg_bounds_pad,
             bs[:, 3].max() - bs[:, 1].min() + 2 * epsg_bounds_pad)
    cell, short_of = max(sides) / 2048, min(sides) / max(sides)
    inside = tvector.points_near_polygons(polys, pts, 0.0)
    edges = [tvector._ring_edges(r) for g in polys for r in [g.exterior] + g.holes]
    d = tvector._distance_to_edges(pts, np.concatenate([e[0] for e in edges]),
                                   np.concatenate([e[1] for e in edges]))
    signed = np.where(inside, -d, d)
    return (signed < dist * short_of - 2 * cell) | (signed > dist + 2 * cell)


@pytest.mark.parametrize("buffer_m", [0.0, 1.0, 2.5])
def test_select_mesh_ROI_matches_jax(survey, buffer_m):
    """Unbuffered: the same faces.  Buffered: the same decision for every
    vertex clear of the buffer's edge by the raster buffer's tolerance,
    and so the same faces among those whose vertices all are."""
    jmesh, mesh = both(survey)
    roi = survey["labels_vector_file"]
    (jsub, jmask), (sub, mask) = (jmesh.select_mesh_ROI(roi, buffer_m),
                                  mesh.select_mesh_ROI(roi, buffer_m))
    if buffer_m == 0.0:
        np.testing.assert_array_equal(mask, jmask)
        same_mesh(jsub, sub)
        # the box footprints hold no whole face: a wider polygon does
        x0, y0, x1, y1 = tvector.VectorData.read_file(roi).total_bounds()
        ring = [[x0 - 3, y0 - 3], [x1 + 3, y0 - 3], [x1 + 3, y1 + 3], [x0 - 3, y1 + 3]]
        (jsub, jmask), (sub, mask) = (
            jmesh.select_mesh_ROI(jvector.Polygon(ring), default_CRS=survey["utm_epsg"]),
            mesh.select_mesh_ROI(tvector.Polygon(ring), default_CRS=survey["utm_epsg"]))
        assert 0 < mask.sum() < mesh.n_faces
        np.testing.assert_array_equal(mask, jmask)
        same_mesh(jsub, sub)
        return
    else:
        assert 0 < mask.sum() < mesh.n_faces
        vd = tvector.VectorData.read_file(roi)
        verts2d = mesh.get_vertices_in_CRS(vd.epsg)[:, :2]
        clear = _far_from_buffer_edge(vd.geometries, verts2d, buffer_m,
                                      buffer_m * 1.5 + 1e-9)
        face_clear = clear[mesh.faces].all(axis=1)
        assert face_clear.mean() > 0.8
        np.testing.assert_array_equal(mask[face_clear], jmask[face_clear])
    # through the constructor, in place, as the entry points crop
    _, cropped = both(survey, ROI=roi, ROI_buffer_meters=buffer_m)
    assert cropped.n_faces == mask.sum() == sub.n_faces
    # a Polygon in the mesh's local frame when neither side has a CRS
    local = TexturedMesh((load_mesh(survey["mesh_file"])[0],
                          load_mesh(survey["mesh_file"])[1]), device="cpu")
    square = tvector.Polygon([[-5, -5], [5, -5], [5, 5], [-5, 5]])
    _, local_mask = local.select_mesh_ROI(square)
    jlocal = JaxTexturedMesh((local.verts, local.faces))
    _, jlocal_mask = jlocal.select_mesh_ROI(jvector.Polygon(square.exterior))
    np.testing.assert_array_equal(local_mask, jlocal_mask)
    assert 0 < local_mask.sum() < local.n_faces


@pytest.mark.parametrize("buffer_m", [0.0, 0.5])
def test_get_subset_ROI_matches_jax(survey, buffer_m):
    jcams = JaxMetashape(survey["cameras_file"], survey["image_folder"])
    cams = MetashapeCameraSet(survey["cameras_file"], survey["image_folder"])
    # the cameras hover over the scene's centre: an ROI around two of them
    lonlat = np.array(cams.get_lon_lat_coords())
    lo, hi = lonlat.min(0), lonlat.max(0)
    half = tvector.Polygon([[lo[0] - 1e-5, lo[1] - 1e-5], [hi[0] + 1e-5, lo[1] - 1e-5],
                            [hi[0] + 1e-5, lo[1] + 1e-5], [lo[0] - 1e-5, lo[1] + 1e-5]])
    jhalf = jvector.Polygon(half.exterior)
    sub = cams.get_subset_ROI(half, buffer_m, is_geospatial=True)
    jsub = jcams.get_subset_ROI(jhalf, buffer_m, is_geospatial=True)
    assert len(sub) == len(jsub) == 2
    assert sub.image_filenames == jsub.image_filenames
    # the entry points' default 50 m around the label polygons holds all
    # four (the JAX package's raster dilation by 50 m takes ~15 s: not run)
    roi = survey["labels_vector_file"]
    assert len(cams.get_subset_ROI(roi, 50.0)) == 4
    assert (cams.get_subset_ROI(roi, 2.0).image_filenames
            == jcams.get_subset_ROI(roi, 2.0).image_filenames)
    far = tvector.Polygon(np.array([[100, 100], [110, 100], [110, 110.0]]))
    assert len(cams.get_subset_ROI(far, buffer_m, is_geospatial=False)) == 0


def test_save_mesh_matches_jax(survey, tmp_path):
    jmesh, mesh = both(survey, texture=survey["labels_vector_file"],
                       texture_column_name="species")
    mesh.save_mesh(tmp_path / "t.ply")
    jmesh.save_mesh(tmp_path / "j.ply")
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    assert "colors" in load_mesh(tmp_path / "t.ply")[2]
    rgb = np.random.default_rng(4).integers(0, 255, (mesh.n_verts, 3)).astype(float)
    for m, name in ((mesh, "t3.ply"), (jmesh, "j3.ply")):
        m.set_texture(rgb)
        m.save_mesh(tmp_path / name)
    assert (tmp_path / "t3.ply").read_bytes() == (tmp_path / "j3.ply").read_bytes()
    mesh.save_mesh(tmp_path / "plain.ply", write_texture=False)
    assert "colors" not in load_mesh(tmp_path / "plain.ply")[2]
