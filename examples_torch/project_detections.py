"""Project per-image object detections onto the mesh and to geospatial, on
the port.

Mirrors the reference's project_detections notebook on a synthetic survey
(no external data needed): DeepForest-format bounding-box detections are
painted per-detection-index by a ``TabularRectangleSegmentor``, projected
onto mesh faces as sparse instance counts, and exported as geospatial
polygons -- plus the triangulation direction (detections -> 3D points) the
notebook's second half demonstrates.

The detector is simulated by projecting each object's centre through the
port's ``project_points`` on the device; the CSV is written by
``csv.DictWriter`` in the column order the JAX script's DataFrame writes.

    python examples_torch/project_detections.py [output_folder] [device]

``device`` is the card by default (the script raises without one);
``cpu`` runs it on the CPU.
"""

import csv
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent.parent))

DETECTION_COLUMNS = ("image_path", "xmin", "xmax", "ymin", "ymax", "label")


def main(out="project_detections_out", device=None):
    import torch

    from geograypher_tpu_torch.utils.device import resolve_device

    device = resolve_device("cuda" if device is None else device,
                            "project_detections.main")
    out = Path(out)

    print("1. generating synthetic survey...")
    from geograypher_tpu_torch.utils.example_data import create_example_survey

    survey = create_example_survey(out / "survey", n_cameras=6, sensor=128,
                                   device=device)

    print("2. writing synthetic DeepForest-format detections...")
    # each camera "detects" the projected scene objects: box detections
    # around each ground-truth object center, in each image that sees it
    from geograypher_tpu_torch.cameras.core import project_points
    from geograypher_tpu_torch.cameras.metashape import MetashapeCameraSet
    from geograypher_tpu_torch.meshes.mesh import TexturedMesh

    cams = MetashapeCameraSet(
        survey["cameras_file"], survey["image_folder"], validate_images=False
    )
    mesh = TexturedMesh(
        survey["mesh_file"], transform_filename=survey["cameras_file"],
        device=device,
    )
    verts_local = mesh.get_verts_in_local_frame(cams)
    labels = survey["face_labels"]
    faces = mesh.faces
    batch = cams.get_camera_batch(device=device)
    rows = []
    object_ids = sorted(set(labels[labels < labels.max()].tolist()))
    for obj in object_ids:
        # object centroid at its canopy height
        vsel = np.unique(faces[labels == obj].reshape(-1))
        center = verts_local[vsel].mean(axis=0)
        center[2] = verts_local[vsel][:, 2].max()
        xy, _d, valid = project_points(
            batch, torch.as_tensor(center[None], dtype=torch.float32,
                                   device=device)
        )
        xy, valid = xy.cpu().numpy(), valid.cpu().numpy()
        for i in range(len(cams)):
            if not valid[i, 0]:
                continue
            x, y = float(xy[i, 0, 0]), float(xy[i, 0, 1])
            rows.append(
                {
                    "image_path": f"img_{i:04d}.png",
                    "xmin": x - 6, "xmax": x + 6,
                    "ymin": y - 6, "ymax": y + 6,
                    "label": f"object_{obj + 1}",
                }
            )
    det_file = out / "detections.csv"
    det_file.parent.mkdir(parents=True, exist_ok=True)
    with open(det_file, "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=DETECTION_COLUMNS,
                                lineterminator="\n")
        writer.writeheader()
        writer.writerows(rows)
    print(f"   {len(rows)} detections across {len(cams)} images")

    print("3. projecting detections onto the mesh -> geospatial polygons...")
    from geograypher_tpu_torch.entrypoints.project_detections import (
        project_detections,
    )

    counts, vd = project_detections(
        mesh_file=survey["mesh_file"],
        cameras_file=survey["cameras_file"],
        image_folder=survey["image_folder"],
        detections_folder=det_file,
        image_shape=(128, 128),
        aggregate_image_scale=1.0,
        projections_to_mesh_savefile=out / "projections_to_mesh.npz",
        projections_to_geospatial_savefile=out
        / "detections_projected_to_geospatial.geojson",
        device=device,
    )
    print(
        f"   {counts.shape[1]} detections painted onto "
        f"{(counts.toarray().sum(axis=1) > 0).sum()} faces; "
        f"{len(vd.geometries)} exported polygons"
    )

    print("4. triangulating the same detections to 3D object locations...")
    from geograypher_tpu_torch.predictors.segmentors import (
        TabularRectangleSegmentor,
    )

    detector = TabularRectangleSegmentor(
        det_file, survey["image_folder"], image_shape=(128, 128)
    )
    points = cams.triangulate_detections(
        detector=detector,
        similarity_threshold_meters=2.0,
        ray_length_meters=200.0,
        out_dir=out / "triangulation_cache",
        device=device,
    )
    print(f"   triangulated {len(points)} object location(s) "
          f"(expected ~{len(object_ids)})")
    print(f"done; products in {out}/")
    return len(points)


if __name__ == "__main__":
    main(*sys.argv[1:3])
