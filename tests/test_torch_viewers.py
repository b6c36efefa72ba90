"""The port's viewers against the JAX package: the colour tables and
lookup rule against matplotlib's, composites against the JAX
``create_composite`` (<= 1e-7), ``show_segmentation_labels`` and
``save_renders(make_composites=True)`` files decoded, the HTML viewer's
bytes, and ``visualize``'s value map; also ``render_labels(vis=True)``
with composites on both routes."""

import cv2
import matplotlib.pyplot as plt
import numpy as np
import pytest

from geograypher_tpu.cameras.core import CameraSet as JaxCameraSet
from geograypher_tpu.cameras.metashape import MetashapeCameraSet as JaxMetashape
from geograypher_tpu.entrypoints.visualize import visualize as jax_visualize
from geograypher_tpu.meshes.mesh import TexturedMesh as JaxTexturedMesh
from geograypher_tpu.ops.rasterize import RasterConfig as JaxRasterConfig
from geograypher_tpu.utils import html_viewer as jhtml
from geograypher_tpu.utils import visualization as jvis
from geograypher_tpu.utils.fixtures import make_grid_mesh, nadir_camera, oblique_camera
from geograypher_tpu_torch import interop
from geograypher_tpu_torch.entrypoints.render_labels import render_labels
from geograypher_tpu_torch.entrypoints.visualize import value_map_image, visualize
from geograypher_tpu_torch.meshes.mesh import TexturedMesh
from geograypher_tpu_torch.utils import html_viewer as thtml
from geograypher_tpu_torch.utils import visualization as tvis
from geograypher_tpu_torch.utils.colormaps import COLORMAPS, colormap
from geograypher_tpu_torch.utils.example_data import create_example_survey
from geograypher_tpu_torch.utils.io import read_image_or_numpy, write_image
from tests.test_torch_rasterize import knife_edge, one_torch_thread  # noqa: F401

COMPOSITE_ATOL = 1e-7
W, H = 96, 64
XLA = JaxRasterConfig(caps=(640, 160, 64, 32), backend="xla")


def test_colour_tables_and_rule_match_matplotlib():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.random(20000), np.linspace(0, 1, 1001),
                        [-0.5, -1e-12, 1.0, 1 + 1e-12, 7.0, np.nan]])
    for name, table in COLORMAPS.items():
        cmap = plt.get_cmap(name)
        np.testing.assert_array_equal(table, cmap(np.arange(cmap.N))[:, :3])
        np.testing.assert_array_equal(colormap(name, x), cmap(x))
        grid = x[: x.size // 3 * 3].reshape(-1, 3)
        np.testing.assert_array_equal(colormap(name, grid), cmap(grid))


def label_image(rng, n_classes, shape=(H, W)):
    lab = rng.integers(0, n_classes, shape).astype(float)
    lab[rng.random(shape) < 0.2] = np.nan
    return lab


@pytest.mark.parametrize("case", ["uint8", "float255", "float01", "gray", "label3d"])
@pytest.mark.parametrize("n_classes", [None, 4, 15, 25])
def test_create_composite_matches_jax(case, n_classes):
    rng = np.random.default_rng(1)
    rgb = {"uint8": rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
           "float255": rng.random((H, W, 3)) * 255,
           "float01": rng.random((H, W, 3)),
           "gray": rng.integers(0, 256, (H, W), dtype=np.uint8),
           "label3d": rng.integers(0, 256, (H, W, 3), dtype=np.uint8)}[case]
    lab = label_image(rng, n_classes or 7)
    if case == "label3d":
        lab = np.stack([lab, lab], axis=-1)
    ids = None if n_classes is None else {k: f"class_{k}" for k in range(n_classes)}
    for kwargs in ({}, dict(label_blending_weight=0.3, grayscale_rgb_overlay=False)):
        got = tvis.create_composite(rgb, lab, ids, **kwargs)
        want = jvis.create_composite(rgb, lab, ids, **kwargs)
        assert got.shape == want.shape == (H, 3 * W, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=COMPOSITE_ATOL)
    assert tvis.get_vis_options_from_IDs_to_labels(ids) == \
        jvis.get_vis_options_from_IDs_to_labels(ids)


def test_show_segmentation_labels_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    for sub in ("a", "b"):
        for k in range(2):
            lab = rng.integers(0, 5, (H, W)).astype(np.uint8)
            lab[rng.random((H, W)) < 0.1] = 255
            write_image(tmp_path / "labels" / sub / f"v{k}.png", lab)
            write_image(tmp_path / "images" / sub / f"v{k}.png",
                        rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
    ids = {k: str(k) for k in range(5)}
    got = tvis.show_segmentation_labels(tmp_path / "labels", tmp_path / "images",
                                        tmp_path / "t", num_show=3, IDs_to_labels=ids)
    want = jvis.show_segmentation_labels(tmp_path / "labels", tmp_path / "images",
                                         tmp_path / "j", num_show=3, IDs_to_labels=ids)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=COMPOSITE_ATOL)
    files = sorted(p.relative_to(tmp_path / "t") for p in (tmp_path / "t").rglob("*.png"))
    assert files == sorted(p.relative_to(tmp_path / "j")
                           for p in (tmp_path / "j").rglob("*.png"))
    for rel in files:
        np.testing.assert_array_equal(read_image_or_numpy(tmp_path / "t" / rel),
                                      read_image_or_numpy(tmp_path / "j" / rel))


def test_frustum_helpers_match_jax():
    c2w = oblique_camera(4.0, 60.0, W, pitch_deg=20.0)
    np.testing.assert_array_equal(thtml.frustum_lines(c2w, 60.0, W, H, 0.3),
                                  jhtml.frustum_lines(c2w, 60.0, W, H, 0.3))
    for a, b in zip(tvis.camera_frustum_mesh(c2w, 60.0, 1.5, -2.0, W, H),
                    jvis.camera_frustum_mesh(c2w, 60.0, 1.5, -2.0, W, H)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(3)
    for values in (rng.integers(0, 30, 200).astype(float), rng.normal(size=200),
                   np.full(10, np.nan)):
        values[::7] = np.nan
        np.testing.assert_array_equal(thtml.colors_for_values(values),
                                      jhtml.colors_for_values(values))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A labelled grid mesh and 4 views whose raw images lie on disk, two
    at the render's size and two at another (the composite resizes)."""
    folder = tmp_path_factory.mktemp("viewers")
    verts, faces = make_grid_mesh(
        n=25, size=4.0, z_fn=lambda x, y: 0.15 * np.sin(3 * x) * np.cos(2 * y))
    jmesh = JaxTexturedMesh((verts, faces))
    rng = np.random.default_rng(4)
    labels = rng.integers(0, 5, jmesh.n_faces).astype(float)
    labels[rng.random(jmesh.n_faces) < 0.15] = np.nan
    jmesh.set_texture(labels, is_vertex=False)
    jmesh.IDs_to_labels = {k: f"species_{k}" for k in range(5)}
    c2ws = [nadir_camera(4.0, 60.0, W),
            oblique_camera(4.0, 70.0, W, pitch_deg=25.0, azimuth_deg=30.0),
            oblique_camera(4.0, 60.0, W, pitch_deg=30.0, azimuth_deg=200.0),
            nadir_camera(4.0, 45.0, W)]
    c2ws[0][:3, 3] += (0.0123, -0.0217, 0.031)  # off the pixel grid
    names = []
    for k, size in enumerate([(H, W), (2 * H + 3, 2 * W - 5), (H, W), (H // 2, W // 2)]):
        names.append(folder / "raw" / f"view_{k}.png")
        write_image(names[-1], rng.integers(0, 256, size + (3,), dtype=np.uint8))
    sensors = {0: {"f": 60.0, "cx": 0.0, "cy": 0.0, "image_width": W, "image_height": H},
               1: {"f": 70.0, "cx": 0.0, "cy": 0.0, "image_width": W, "image_height": H}}
    jcams = JaxCameraSet(c2ws, sensors, sensor_IDs=[0, 1, 0, 1], image_filenames=names)
    mesh = interop.mesh_from_jax(jmesh, device="cpu")
    mesh.raster_config = interop.raster_config_from_jax(XLA)
    mesh.IDs_to_labels = dict(jmesh.IDs_to_labels)
    return jmesh, jcams, mesh, interop.cameras_from_jax(jcams), folder


def test_save_renders_composites_match_jax(scene, tmp_path):
    """``<stem>_composite.png`` beside every mask.  Decoded, the port's
    file is the JAX ``create_composite`` of the port's own render and the
    raw image; against the JAX package's file, equal in every column of
    pixels whose renders agree, the image panes within +-1 where the raw
    image was resized (cv2 resizes in fixed point)."""
    jmesh, jcams, mesh, cams, _ = scene
    mesh.save_renders(cams, output_folder=tmp_path / "t", make_composites=True)
    jmesh.save_renders(jcams, output_folder=tmp_path / "j", make_composites=True,
                       config=XLA)
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir())
    assert [n for n in names if n.endswith("_composite.png")] == \
        [f"view_{k}_composite.png" for k in range(4)]
    renders = list(mesh.render_flat(cams))
    want_p2f = jmesh.pix2face(jcams, config=XLA)
    got_p2f = mesh.pix2face(cams)
    for k in range(4):
        ours = read_image_or_numpy(tmp_path / "t" / f"view_{k}_composite.png")
        theirs = cv2.cvtColor(cv2.imread(str(tmp_path / "j" / f"view_{k}_composite.png")),
                              cv2.COLOR_BGR2RGB)
        raw = read_image_or_numpy(cams.image_filenames[k])
        if raw.shape[:2] != (H, W):
            raw = cv2.resize(raw, (W, H))  # the JAX composite's own resize
            tol = 1
        else:
            tol = 0
        plain = jvis.create_composite(raw, renders[k][..., 0], mesh.IDs_to_labels)
        plain = (np.clip(plain, 0, 1) * 255).astype(np.uint8)
        assert ours.shape == theirs.shape == (H, 3 * W, 3)
        np.testing.assert_allclose(ours.astype(int), plain.astype(int), rtol=0, atol=tol)
        same = np.tile(got_p2f[k] == want_p2f[k], (1, 3))
        assert same.mean() >= 0.99
        np.testing.assert_allclose(ours[same].astype(int), theirs[same].astype(int),
                                   rtol=0, atol=tol)


def test_html_viewer_bytes_match_jax(scene, tmp_path):
    jmesh, jcams, mesh, cams, _ = scene
    path = tmp_path / "viewer.html"  # the file's title is its path
    for max_faces, cameras in ((400_000, (cams, jcams)), (300, (None, None))):
        mesh.export_html_viewer(path, cameras=cameras[0], max_faces=max_faces)
        got = path.read_bytes()
        jmesh.export_html_viewer(path, cameras=cameras[1], max_faces=max_faces)
        assert got == path.read_bytes()
        assert got.startswith(b"<!DOCTYPE html>") and len(got) > 10_000


@pytest.fixture(scope="module")
def survey(tmp_path_factory):
    return create_example_survey(tmp_path_factory.mktemp("survey"), device="cpu")


def test_visualize_value_map_matches_jax(survey, tmp_path):
    """With the faces' ids as the texture, the value map is the ortho
    pix2face: the knife-edge contract against the JAX package's, the image
    its viridis colouring with the cameras marked red, written as PNG."""
    n_faces = TexturedMesh(survey["mesh_file"], device="cpu").n_faces
    texture = tmp_path / "ids.npy"
    np.save(texture, np.arange(n_faces, dtype=float))
    stats = {}
    kwargs = dict(mesh_file=survey["mesh_file"], cameras_file=survey["cameras_file"],
                  image_folder=survey["image_folder"], texture=texture, resolution_m=0.25)
    image = visualize(**kwargs, screenshot_filename=tmp_path / "t.png",
                      export_html=tmp_path / "t.html", device="cpu", stats=stats)
    jax_visualize(**kwargs, screenshot_filename=tmp_path / "j.png",
                  export_html=tmp_path / "j.html")
    jmesh = JaxTexturedMesh(survey["mesh_file"], transform_filename=survey["cameras_file"],
                            texture=texture)
    want, bounds, epsg = jmesh.ortho_pix2face(resolution_m=0.25)
    values = stats["values"]
    assert values.shape == want.shape and stats["epsg"] == epsg
    np.testing.assert_allclose(stats["bounds"], bounds, rtol=0, atol=1e-9)
    got = np.where(np.isfinite(values), values, -1).astype(np.int64)
    knife_edge(got, want)
    assert (got >= 0).mean() > 0.5
    np.testing.assert_array_equal(read_image_or_numpy(tmp_path / "t.png"), image)
    plain = value_map_image(values)
    red = (image == (255, 0, 0)).all(axis=-1)
    assert 0 < red.sum() <= 4 * 9  # four cameras, 3 x 3 px each
    np.testing.assert_array_equal(image[~red], plain[~red])
    assert (image[~np.isfinite(values) & ~red] == 255).all()
    got = (tmp_path / "t.html").read_bytes()
    jmesh.export_html_viewer(tmp_path / "t.html",
                             cameras=JaxMetashape(survey["cameras_file"],
                                                  survey["image_folder"]))
    assert got == (tmp_path / "t.html").read_bytes()


@pytest.mark.parametrize("chunked", [False, True])
def test_render_labels_composites_and_vis(survey, tmp_path, chunked):
    render_labels(survey["mesh_file"], survey["cameras_file"], survey["image_folder"],
                  survey["labels_vector_file"], tmp_path / "r",
                  texture_column_name="species", make_composites=True, vis=True,
                  n_cameras_per_chunk=2 if chunked else None, device="cpu")
    names = sorted(p.name for p in (tmp_path / "r").iterdir())
    assert names == sorted([f"img_{k:04d}.png" for k in range(4)]
                           + [f"img_{k:04d}_composite.png" for k in range(4)])
    for k in range(4):
        mask = read_image_or_numpy(tmp_path / "r" / f"img_{k:04d}.png").astype(float)
        mask[mask == 255] = np.nan
        raw = read_image_or_numpy(survey["image_folder"] / f"img_{k:04d}.png")
        plain = jvis.create_composite(raw, mask, {0: "a", 1: "b", 2: "c"})
        comp = read_image_or_numpy(tmp_path / "r" / f"img_{k:04d}_composite.png")
        np.testing.assert_array_equal(comp, (np.clip(plain, 0, 1) * 255).astype(np.uint8))


@pytest.mark.parametrize("mode", ["L", "RGB", "I;16", "F"])
def test_raw_tiff_images_read_without_imageio(tmp_path, monkeypatch, mode):
    """Raw images in TIFF read through the port's own codec, as PIL reads
    them; imageio is refused (the card's machine has none)."""
    import sys

    from PIL import Image

    rng = np.random.default_rng(6)
    data = {"L": rng.integers(0, 256, (H, W), dtype=np.uint8),
            "RGB": rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
            "I;16": rng.integers(0, 65536, (H, W), dtype=np.uint16),
            "F": rng.random((H, W)).astype(np.float32)}[mode]
    path = tmp_path / "raw.tif"
    Image.fromarray(data).save(path)
    monkeypatch.setitem(sys.modules, "imageio", None)
    got = read_image_or_numpy(path)
    np.testing.assert_array_equal(got, np.asarray(Image.open(path)))
    np.testing.assert_array_equal(got, data)


def test_visualize_entry_point_registered_and_parses(monkeypatch):
    """Registered as the JAX package's entry points are; the CLI takes the
    JAX package's arguments and ``--device``."""
    import sys

    from geograypher_tpu.entrypoints import visualize as jax_module
    from geograypher_tpu_torch import entrypoints
    from geograypher_tpu_torch.entrypoints import visualize as port_module

    assert entrypoints.__getattr__("visualize") is visualize
    argv = ["x", "--mesh-file", "m.ply", "--cameras-file", "c.xml",
            "--screenshot-filename", "s.png"]
    monkeypatch.setattr(sys, "argv", argv)
    want = vars(jax_module.parse_args())
    monkeypatch.setattr(sys, "argv", argv + ["--device", "cpu"])
    got = vars(port_module.parse_args())
    assert got == {**want, "device": "cpu"}
