"""Visualization helpers (numpy, on the host).

Port of ``geograypher_tpu/utils/visualization.py``.  Composites colour
labels with the port's own copies of matplotlib's tables and lookup rule
(``utils/colormaps.py``) and write PNG files with the port's writer, so
they need neither matplotlib nor cv2: a composite file decodes to the
pixels of the JAX package's (cv2 is handed an array in BGR order, so its
file holds RGB).  Only :func:`visualize_intersections`, a 3D plot, imports
matplotlib, when it is called, as a viewer of the host.
"""

from __future__ import annotations

import typing
from pathlib import Path

import numpy as np

from geograypher_tpu_torch.constants import PATH_TYPE
from geograypher_tpu_torch.utils.colormaps import colormap
from geograypher_tpu_torch.utils.files import ensure_folder
from geograypher_tpu_torch.utils.io import read_image_or_numpy, resize_linear, write_image


def get_vis_options_from_IDs_to_labels(
    IDs_to_labels: typing.Optional[dict],
    cmap_continuous: str = "viridis",
    cmap_10_classes: str = "tab10",
    cmap_20_classes: str = "tab20",
    cmap_many_classes: str = "viridis",
):
    """Colormap name, limits and label names for a label set: continuous
    values without ``IDs_to_labels``, else a categorical table by the
    number of classes, each class centred on its bin."""
    if IDs_to_labels is None:
        return {"cmap": cmap_continuous, "vmin": None, "vmax": None, "labels": None}
    n = len(IDs_to_labels)
    if n <= 10:
        cmap = cmap_10_classes
    elif n <= 20:
        cmap = cmap_20_classes
    else:
        cmap = cmap_many_classes
    return {
        "cmap": cmap,
        "vmin": -0.5,
        "vmax": n - 0.5,
        "labels": [IDs_to_labels[k] for k in sorted(IDs_to_labels)],
    }


def create_composite(
    rgb_image: np.ndarray,
    label_image: np.ndarray,
    IDs_to_labels: typing.Optional[dict] = None,
    label_blending_weight: float = 0.5,
    grayscale_rgb_overlay: bool = True,
) -> np.ndarray:
    """(H, 3W, 3) float64 label | RGB | overlay composite in [0, 1]: the
    labels coloured (NaN white), the image, and the coloured labels
    blended over the image (grey by default) where a label is finite.  A
    uint8 image is scaled by 1/255, a float one only when its finite
    maximum exceeds 1."""
    if np.asarray(rgb_image).dtype == np.uint8:
        rgb = np.asarray(rgb_image, dtype=float) / 255.0
    else:
        rgb = np.asarray(rgb_image, dtype=float)
        finite = rgb[np.isfinite(rgb)]
        if finite.size and finite.max() > 1.0:
            rgb = rgb / 255.0
    if rgb.ndim == 2:
        rgb = np.stack([rgb] * 3, axis=-1)

    lab = np.asarray(label_image, dtype=float)
    if lab.ndim == 3:
        lab = lab[..., 0]
    opts = get_vis_options_from_IDs_to_labels(IDs_to_labels)
    finite = np.isfinite(lab)
    vmin = opts["vmin"] if opts["vmin"] is not None else np.nanmin(lab) if finite.any() else 0
    vmax = opts["vmax"] if opts["vmax"] is not None else np.nanmax(lab) if finite.any() else 1
    norm = (lab - vmin) / max(vmax - vmin, 1e-9)
    lab_rgb = colormap(opts["cmap"], np.clip(norm, 0, 1))[..., :3]
    lab_rgb[~finite] = 1.0

    base = rgb
    if grayscale_rgb_overlay:
        gray = rgb.mean(axis=-1, keepdims=True)
        base = np.repeat(gray, 3, axis=-1)
    overlay = np.where(
        finite[..., None],
        label_blending_weight * lab_rgb + (1 - label_blending_weight) * base,
        base,
    )
    return np.concatenate([lab_rgb, rgb, overlay], axis=1)


def composite_to_uint8(composite: np.ndarray) -> np.ndarray:
    """The uint8 RGB image a composite file holds."""
    return (np.clip(composite, 0, 1) * 255).astype(np.uint8)


def save_composite(
    label_image: np.ndarray,
    image_file: PATH_TYPE,
    out_path: PATH_TYPE,
    IDs_to_labels: typing.Optional[dict] = None,
) -> np.ndarray:
    """Write the composite of a label image and the raw image in
    ``image_file`` as a PNG at ``out_path``; a raw image of another size
    is first resized to the labels' bilinearly (cv2's default, within +-1
    on uint8).  Returns the composite."""
    label_image = np.asarray(label_image)
    rgb = read_image_or_numpy(image_file)
    if rgb.shape[:2] != label_image.shape[:2]:
        rgb = resize_linear(rgb, label_image.shape[1], label_image.shape[0])
    comp = create_composite(rgb, label_image, IDs_to_labels)
    write_image(out_path, composite_to_uint8(comp))
    return comp


def show_segmentation_labels(
    label_folder: PATH_TYPE,
    image_folder: PATH_TYPE,
    savefolder: typing.Optional[PATH_TYPE] = None,
    num_show: int = 10,
    IDs_to_labels: typing.Optional[dict] = None,
    label_suffix: str = ".png",
):
    """Composites of the first ``num_show`` label files (sorted, searched
    recursively) with the images of the same relative stem; with
    ``savefolder``, each written as ``<stem>_composite.png`` in the label
    tree's layout.  Labels of 255 are unlabelled.  Returns the
    composites."""
    label_folder = Path(label_folder)
    image_folder = Path(image_folder)
    labels = sorted(label_folder.rglob(f"*{label_suffix}"))[:num_show]
    outputs = []
    for lab_path in labels:
        rel = lab_path.relative_to(label_folder)
        img_candidates = list(image_folder.glob(str(rel.with_suffix("")) + ".*"))
        if not img_candidates:
            continue
        rgb = read_image_or_numpy(img_candidates[0])
        lab = read_image_or_numpy(lab_path).astype(float)
        if lab.ndim == 3:
            lab = lab[..., 0]
        lab[lab == 255] = np.nan
        comp = create_composite(rgb, lab, IDs_to_labels)
        outputs.append(comp)
        if savefolder is not None:
            # mirror the label tree: same-named labels in different
            # subfolders keep their own composites
            out_path = Path(savefolder) / rel.with_suffix("")
            out_path = out_path.parent / (out_path.name + "_composite.png")
            ensure_folder(out_path.parent)
            write_image(out_path, composite_to_uint8(comp))
    return outputs


def visualize_intersections(
    starts: np.ndarray,
    ends: np.ndarray,
    community_points: np.ndarray,
    ray_IDs: typing.Optional[np.ndarray] = None,
    savefile: typing.Optional[PATH_TYPE] = None,
):
    """3D matplotlib plot of triangulation rays and community points, a
    viewer of the host: matplotlib is imported here, not with the
    module.  Returns the figure (closed; saved to ``savefile``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(projection="3d")
    colors = None
    if ray_IDs is not None:
        cmap = plt.get_cmap("tab20")
        colors = [
            cmap(int(i) % 20) if np.isfinite(i) else (0.7, 0.7, 0.7, 0.3)
            for i in ray_IDs
        ]
    for k in range(len(starts)):
        c = colors[k] if colors else "gray"
        ax.plot(
            [starts[k, 0], ends[k, 0]],
            [starts[k, 1], ends[k, 1]],
            [starts[k, 2], ends[k, 2]],
            color=c,
            linewidth=0.5,
        )
    if len(community_points):
        ax.scatter(
            community_points[:, 0],
            community_points[:, 1],
            community_points[:, 2],
            color="red",
            s=40,
            marker="*",
        )
    if savefile is not None:
        fig.savefig(savefile, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return fig


def camera_frustum_mesh(
    cam_to_world: np.ndarray,
    f: float,
    cx: float,
    cy: float,
    image_width: int,
    image_height: int,
    frustum_scale: float = 0.1,
):
    """A camera's frustum as a mesh (verts, faces, face colours): a blue
    pyramid with a red face on the image's top."""
    scaled_halfwidth = image_width / (f * 2)
    scaled_halfheight = image_height / (f * 2)
    scx, scy = cx / f, cy / f
    right = scx + scaled_halfwidth
    left = scx - scaled_halfwidth
    top = scy + scaled_halfheight
    bottom = scy - scaled_halfheight
    verts = np.array(
        [[0, 0, 0], [right, top, 1], [right, bottom, 1], [left, bottom, 1],
         [left, top, 1]]
    ) * frustum_scale
    hom = np.concatenate([verts, np.ones((5, 1))], axis=1)
    world = (np.asarray(cam_to_world) @ hom.T).T
    world = world[:, :3] / world[:, 3:4]
    faces = np.array(
        [[0, 1, 2], [0, 2, 3], [0, 3, 4], [0, 4, 1], [1, 2, 3], [3, 4, 1]],
        dtype=np.int32,
    )
    colors = np.array(
        [[0, 0, 255], [255, 0, 0], [0, 0, 255], [0, 0, 255], [0, 0, 255],
         [0, 0, 255]],
        dtype=np.uint8,
    )
    return world, faces, colors
