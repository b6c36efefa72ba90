"""Generate the framework's concept-figure assets, on the port.

Mirrors the reference's concept_figure notebook on purely synthetic data: a
procedural scene of cubes, cylinders, and cones on a ground plane is
rendered two ways -- "realistic" per-instance colors and semantic class
labels -- from an orbit of cameras, then the label images are aggregated
back onto the mesh through the segmentor path to close the loop, and the
figure panels are written as PNGs.

The panels are composed in numpy, with no matplotlib:
``figures/concept_views.png`` is a 2 x 3 grid, the realistic views 0-2 on
top and their label images below through the port's tab10 table
(``utils/colormaps.py``), unlabelled pixels white; and
``figures/object_map.png`` is a top-down map of the ground-truth
footprints, each filled by ``utils/polyfill.py`` in its class's tab10
colour at 0.6 opacity over white.  There are no titles, axes or legends:
the port has no font renderer.

The mesh keeps the JAX script's fixed tile-list caps (2048, 256, 64, 32).
The port raises where a view overflows its caps (the JAX package drops the
overflow silently); no view of this orbit overflows them, so they are not
sized by a census here.

    python examples_torch/concept_figure.py [output_folder] [device]

``device`` is the card by default (the script raises without one);
``cpu`` runs it on the CPU.
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent.parent))

# Notebook knobs
N_BOXES = 5
N_CYLINDERS = 5
N_CONES = 5
MAP_RANDOM_SEED = 42
GROUND_RESOLUTION = 60
IDS_TO_LABELS = {0: "cone", 1: "cube", 2: "cylinder"}
SENSOR = 192
FOCAL = 96.0
N_CAMERAS = 6
PANEL_GAP = 8  # white pixels between and around the figure's panels
MAP_PX = 512  # side of the footprint map
MAP_ALPHA = 0.6


def hsv_to_rgb(hsv):
    """(..., 3) HSV in [0, 1] to RGB, as ``matplotlib.colors.hsv_to_rgb``."""
    hsv = np.asarray(hsv, dtype=np.float64)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = (h * 6.0).astype(int)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    sector = i % 6
    r = np.choose(sector, [v, q, p, p, t, v])
    g = np.choose(sector, [t, v, v, q, p, p])
    b = np.choose(sector, [p, p, t, v, v, q])
    gray = s == 0
    r, g, b = (np.where(gray, v, c) for c in (r, g, b))
    return np.stack([r, g, b], axis=-1)


def instance_colors(names, rng):
    """Per-instance RGB colors: a hue gradient within each class family,
    like the notebook's ``make_color_gradient``."""
    base_hue = {"cone": 0.05, "cube": 0.35, "cylinder": 0.6}
    colors = []
    for name in names:
        h = (base_hue[name] + rng.uniform(-0.05, 0.05)) % 1.0
        colors.append(hsv_to_rgb([h, 0.8, 0.9]))
    return np.asarray(colors)


def _panel_grid(panels):
    """Rows of equal-size (H, W, 3) uint8 panels tiled with white gaps."""
    h, w = panels[0][0].shape[:2]
    n_rows, n_cols = len(panels), len(panels[0])
    grid = np.full((n_rows * (h + PANEL_GAP) + PANEL_GAP,
                    n_cols * (w + PANEL_GAP) + PANEL_GAP, 3), 255, np.uint8)
    for r, row in enumerate(panels):
        for c, panel in enumerate(row):
            y = PANEL_GAP + r * (h + PANEL_GAP)
            x = PANEL_GAP + c * (w + PANEL_GAP)
            grid[y:y + h, x:x + w] = panel
    return grid


def label_panel(lab):
    """(H, W) uint8 label image (255 unlabelled) as tab10 RGB, as
    ``imshow(cmap="tab10", vmin=-0.5, vmax=9.5)`` colours it, unlabelled
    pixels white."""
    from geograypher_tpu_torch.utils.colormaps import colormap

    lab = lab.astype(np.float64)
    rgb = colormap("tab10", (lab + 0.5) / 10.0)[..., :3]
    rgb[lab == 255] = 1.0
    return np.round(rgb * 255).astype(np.uint8)


def footprint_map(geometries, names):
    """(MAP_PX, MAP_PX, 3) uint8 top-down map of the footprints, north up."""
    from geograypher_tpu_torch.utils.colormaps import TAB10
    from geograypher_tpu_torch.utils.polyfill import fill_poly

    name_to_class = {v: k for k, v in IDS_TO_LABELS.items()}
    rings = [np.asarray(g.exterior, dtype=np.float64) for g in geometries]
    xy = np.concatenate(rings)
    lo, hi = xy.min(axis=0), xy.max(axis=0)
    margin = 0.05 * float((hi - lo).max())
    lo, hi = lo - margin, hi + margin
    scale = (MAP_PX - 1) / float((hi - lo).max())
    canvas = np.ones((MAP_PX, MAP_PX, 3))
    for ring, name in zip(rings, names):
        px = np.round((ring[:, 0] - lo[0]) * scale).astype(np.int64)
        py = np.round((hi[1] - ring[:, 1]) * scale).astype(np.int64)
        mask = fill_poly(np.zeros((MAP_PX, MAP_PX), np.uint8),
                         np.stack([px, py], axis=1), 1).astype(bool)
        color = TAB10[name_to_class[name]]
        canvas[mask] = (1 - MAP_ALPHA) * canvas[mask] + MAP_ALPHA * color
    return np.round(canvas * 255).astype(np.uint8)


def main(out="concept_figure_out", device=None):
    from geograypher_tpu_torch.utils.device import resolve_device

    device = resolve_device("cuda" if device is None else device,
                            "concept_figure.main")
    out = Path(out)
    (out / "realistic_images").mkdir(parents=True, exist_ok=True)
    (out / "labeled_images").mkdir(parents=True, exist_ok=True)
    (out / "figures").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(MAP_RANDOM_SEED)

    print("1. building the procedural scene mesh...")
    from geograypher_tpu_torch.utils.example_data import (
        create_non_overlapping_points,
        create_scene_mesh,
    )

    points = create_non_overlapping_points(
        n_points=N_BOXES + N_CYLINDERS + N_CONES,
        random_seed=MAP_RANDOM_SEED,
    )
    verts, faces, face_ids, labels_vd = create_scene_mesh(
        box_centers=points[:N_BOXES],
        cylinder_centers=points[N_BOXES : N_BOXES + N_CYLINDERS],
        cone_centers=points[N_BOXES + N_CYLINDERS :],
        add_ground=True,
        ground_resolution=GROUND_RESOLUTION,
    )
    names = list(labels_vd.attributes["name"])
    name_to_class = {v: k for k, v in IDS_TO_LABELS.items()}
    print(f"   {faces.shape[0]} faces, {len(names)} object instances")

    print("2. building the camera orbit...")
    from geograypher_tpu_torch.cameras.core import CameraSet
    from geograypher_tpu_torch.meshes.mesh import TexturedMesh
    from geograypher_tpu_torch.ops.rasterize import RasterConfig
    from geograypher_tpu_torch.utils.fixtures import oblique_camera
    from geograypher_tpu_torch.utils.io import read_image_or_numpy, write_image

    c2ws, img_names = [], []
    for k in range(N_CAMERAS):
        c2w = oblique_camera(
            12.0, FOCAL, SENSOR, pitch_deg=35.0,
            azimuth_deg=360.0 * k / N_CAMERAS,
        )
        c2ws.append(c2w)
        img_names.append(f"view_{k:02d}.png")
    cams = CameraSet(
        c2ws,
        {0: {"f": FOCAL, "cx": 0.0, "cy": 0.0,
             "image_width": SENSOR, "image_height": SENSOR}},
        image_filenames=[out / "realistic_images" / n for n in img_names],
        validate_images=False,
    )

    mesh = TexturedMesh(
        (verts, faces), raster_config=RasterConfig(caps=(2048, 256, 64, 32)),
        device=device,
    )

    print("3. rendering realistic + label views...")
    colors = instance_colors(names, rng)
    inst = np.nan_to_num(face_ids, nan=-1).astype(int)
    face_rgb = np.where(
        (inst >= 0)[:, None], colors[np.clip(inst, 0, None)],
        np.array([[0.45, 0.4, 0.35]]),  # ground
    )
    face_class = np.where(
        inst >= 0,
        np.array([name_to_class[names[i]] for i in np.clip(inst, 0, None)]),
        np.nan,
    )

    mesh.set_texture(face_rgb, is_vertex=False)
    for k, img in enumerate(mesh.render_flat(cams)):
        rgb = np.nan_to_num(img, nan=0.9)
        write_image(
            out / "realistic_images" / img_names[k],
            (np.clip(rgb, 0, 1) * 255).astype(np.uint8),
        )
    mesh.set_texture(face_class, is_vertex=False)
    for k, img in enumerate(mesh.render_flat(cams)):
        lab = np.where(np.isfinite(img[..., 0]), img[..., 0], 255)
        write_image(
            out / "labeled_images" / img_names[k],
            lab.astype(np.uint8),
        )

    print("4. aggregating the labels back onto the mesh (closing the loop)...")
    import torch

    from geograypher_tpu_torch.cameras.segmentor_set import SegmentorCameraSet
    from geograypher_tpu_torch.ops.aggregate import find_argmax_nonzero_value
    from geograypher_tpu_torch.predictors.segmentors import LookUpSegmentor

    segmentor = LookUpSegmentor(
        base_folder=out / "realistic_images",
        lookup_folder=out / "labeled_images",
        num_classes=len(IDS_TO_LABELS),
    )
    agg, _ = mesh.aggregate_projected_images(
        SegmentorCameraSet(cams, segmentor)
    )
    pred = find_argmax_nonzero_value(torch.as_tensor(agg)).numpy()
    seen = np.isfinite(pred) & np.isfinite(face_class)
    agreement = float(np.mean(pred[seen] == face_class[seen]))
    print(f"   round-trip label agreement on {int(seen.sum())} observed "
          f"object faces: {agreement:.1%}")

    print("5. writing figure panels...")
    top, bottom = [], []
    for k in range(3):
        top.append(read_image_or_numpy(out / "realistic_images" / img_names[k]))
        bottom.append(label_panel(
            read_image_or_numpy(out / "labeled_images" / img_names[k])))
    write_image(out / "figures" / "concept_views.png", _panel_grid([top, bottom]))
    # top-down map of the ground-truth footprints
    write_image(out / "figures" / "object_map.png",
                footprint_map(labels_vd.geometries, names))
    print(f"done; figures in {out}/figures/")
    return agreement


if __name__ == "__main__":
    main(*sys.argv[1:3])
