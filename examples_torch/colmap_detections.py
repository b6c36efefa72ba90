"""Triangulate object detections from a COLMAP reconstruction, on the port.

Mirrors the reference's COLMAP_detections notebook on synthetic data (no
external data needed): a ring of cameras is exported in COLMAP's text
format (cameras.txt / images.txt / points3D.txt), parsed back through
``COLMAPCameraSet``, DeepForest-format detections are painted by a
``TabularRectangleSegmentor``, and ``triangulate_detections`` recovers the
3D object locations via the ray-intersection community pipeline.

The detections CSV is written by ``csv.DictWriter`` as the JAX script's
DataFrame writes it (columns image_path, xmin, xmax, ymin, ymax, label,
which the port's ``TabularRectangleSegmentor`` reads by name; numbers as
their shortest round-trip text; "\n" line ends).

    python examples_torch/colmap_detections.py [output_folder] [device]

``device`` is the card by default (the script raises without one);
``cpu`` runs it on the CPU.
"""

import csv
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent.parent))

N_CAMERAS = 8
N_OBJECTS = 3
F = 200.0
W = H = 256
DETECTION_COLUMNS = ("image_path", "xmin", "xmax", "ymin", "ymax", "label")


def look_at_w2c(eye, target, up=(0, 0, 1)):
    """World->cam rotation+translation for a camera at ``eye`` looking at
    ``target`` (+z forward, +x right, +y down -- the framework/COLMAP
    convention)."""
    eye, target = np.asarray(eye, float), np.asarray(target, float)
    fwd = target - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, float))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    r_c2w = np.stack([right, down, fwd], axis=1)
    w2c = np.eye(4)
    w2c[:3, :3] = r_c2w.T
    w2c[:3, 3] = -r_c2w.T @ eye
    return w2c


def matrix_to_quat_wxyz(m):
    from scipy.spatial.transform import Rotation

    x, y, z, w = Rotation.from_matrix(m).as_quat()
    return w, x, y, z


def main(out="colmap_detections_out", device=None):
    from geograypher_tpu_torch.utils.device import resolve_device

    device = resolve_device("cuda" if device is None else device,
                            "colmap_detections.main")
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(3)

    print("1. synthesizing the scene + COLMAP text exports...")
    # objects ("birds") near the origin; cameras on a ring above them
    objects = rng.uniform(-2.0, 2.0, (N_OBJECTS, 3))
    objects[:, 2] = rng.uniform(0.0, 0.5, N_OBJECTS)
    keypoints = rng.uniform(-4.0, 4.0, (200, 3))
    keypoints[:, 2] = rng.uniform(-0.5, 1.0, 200)

    w2cs = []
    names = []
    for k in range(N_CAMERAS):
        ang = 2 * np.pi * k / N_CAMERAS
        eye = (6 * np.cos(ang), 6 * np.sin(ang), 8.0)
        w2cs.append(look_at_w2c(eye, (0, 0, 0)))
        names.append(f"frame_{k:03d}.jpg")

    cameras_txt = out / "cameras.txt"
    cameras_txt.write_text(
        "# Camera list with one line of data per camera:\n"
        "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n"
        "# Number of cameras: 1\n"
        f"1 SIMPLE_RADIAL {W} {H} {F} {W / 2} {H / 2} 0.0\n"
    )
    lines = [
        "# Image list with two lines of data per image:",
        "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME",
        "#   POINTS2D[] as (X, Y, POINT3D_ID)",
        f"# Number of images: {N_CAMERAS}",
    ]
    for k, w2c in enumerate(w2cs):
        qw, qx, qy, qz = matrix_to_quat_wxyz(w2c[:3, :3])
        tx, ty, tz = w2c[:3, 3]
        lines.append(
            f"{k + 1} {qw} {qx} {qy} {qz} {tx} {ty} {tz} 1 {names[k]}"
        )
        lines.append("")  # keypoint line (skipped by the parser)
    images_txt = out / "images.txt"
    images_txt.write_text("\n".join(lines) + "\n")

    points_txt = out / "points3D.txt"
    plines = ["# 3D point list:", "#   POINTS3D_ID, X, Y, Z, R, G, B", "#"]
    for i, p in enumerate(keypoints):
        plines.append(f"{i} {p[0]} {p[1]} {p[2]} 120 140 120")
    points_txt.write_text("\n".join(plines) + "\n")

    print("2. parsing the COLMAP export back through COLMAPCameraSet...")
    from geograypher_tpu_torch.cameras.colmap import COLMAPCameraSet

    camera_set = COLMAPCameraSet(
        cameras_file=cameras_txt,
        images_file=images_txt,
        image_folder=out,
        validate_images=False,
    )
    print(f"   {len(camera_set)} cameras parsed")

    print("3. projecting objects -> DeepForest detection CSV...")
    rows = []
    for k, w2c in enumerate(w2cs):
        cam_pts = (w2c[:3, :3] @ objects.T).T + w2c[:3, 3]
        for j, p in enumerate(cam_pts):
            if p[2] <= 0:
                continue
            x = float(F * p[0] / p[2] + W / 2)
            y = float(F * p[1] / p[2] + H / 2)
            if not (0 <= x < W and 0 <= y < H):
                continue
            rows.append(
                {
                    "image_path": names[k],
                    "xmin": x - 4, "xmax": x + 4,
                    "ymin": y - 4, "ymax": y + 4,
                    "label": "bird",
                }
            )
    det_file = out / "preds.csv"
    with open(det_file, "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=DETECTION_COLUMNS,
                                lineterminator="\n")
        writer.writeheader()
        writer.writerows(rows)
    print(f"   {len(rows)} detections")

    print("4. triangulating detections to 3D locations...")
    from geograypher_tpu_torch.predictors.segmentors import (
        TabularRectangleSegmentor,
    )

    detector = TabularRectangleSegmentor(
        det_file, out, image_shape=(H, W)
    )
    located = camera_set.triangulate_detections(
        detector=detector,
        similarity_threshold_meters=0.5,
        ray_length_meters=80.0,
        out_dir=out / "triangulation_cache",
        device=device,
    )
    print(f"   recovered {len(located)} locations "
          f"(expected {N_OBJECTS})")
    err = None
    if len(located):
        d = np.linalg.norm(
            located[:, None, :] - objects[None, :, :], axis=-1
        )
        err = d.min(axis=1)
        print(f"   localization error: max {err.max():.3f} m")
    print(f"done; products in {out}/")
    return located, objects


if __name__ == "__main__":
    main(*sys.argv[1:3])
