"""End-to-end demo on a synthetic survey (no external data needed), on the
port.

Mirrors the reference's example notebooks: generate a fake Metashape
export, run the two flagship workflows in both directions, triangulate
detections, and write all products to ./demo_out.

The detector is simulated by projecting the scene's canopy-height centre
through the port's ``project_points`` on the device.  The port's
``visualize`` writes and returns the top-down image as RGB pixels, not a
matplotlib figure.

    python examples_torch/end_to_end_demo.py [output_folder] [device]

``device`` is the card by default (the script raises without one);
``cpu`` runs it on the CPU.
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent.parent))


def main(out="demo_out", device=None):
    from geograypher_tpu_torch.utils.device import resolve_device

    device = resolve_device("cuda" if device is None else device,
                            "end_to_end_demo.main")
    out = Path(out)
    from geograypher_tpu_torch.utils.example_data import create_example_survey

    print("1. generating synthetic survey...")
    survey = create_example_survey(out / "survey", n_cameras=6, sensor=128,
                                   device=device)

    print("2. render_labels: geospatial polygons -> per-image masks")
    from geograypher_tpu_torch.entrypoints.render_labels import render_labels

    render_labels(
        mesh_file=survey["mesh_file"],
        cameras_file=survey["cameras_file"],
        image_folder=survey["image_folder"],
        texture=survey["labels_vector_file"],
        texture_column_name="species",
        render_savefolder=out / "rendered_masks",
        device=device,
    )

    print("3. aggregate_images: label images -> per-face map -> GeoJSON")
    from geograypher_tpu_torch.entrypoints.aggregate_images import aggregate_images

    pred, _ = aggregate_images(
        mesh_file=survey["mesh_file"],
        cameras_file=survey["cameras_file"],
        image_folder=survey["image_folder"],
        label_folder=survey["label_folder"],
        take_every_nth_camera=None,
        n_classes=survey["n_classes"],
        top_down_vector_projection_savefile=out / "predicted_map.geojson",
        device=device,
    )
    truth = survey["face_labels"].astype(float)
    seen = np.isfinite(pred)
    print(
        f"   recovered {np.mean(pred[seen] == truth[seen]):.1%} of "
        f"{int(seen.sum())} observed faces"
    )

    print("4. multiview_detections: per-image detections -> 3D points")
    import torch

    from geograypher_tpu_torch.cameras.core import project_points
    from geograypher_tpu_torch.cameras.metashape import MetashapeCameraSet
    from geograypher_tpu_torch.entrypoints.multiview_detections import (
        multiview_detections,
    )
    from geograypher_tpu_torch.meshes.mesh import TexturedMesh
    from geograypher_tpu_torch.utils.vector import Polygon, VectorData

    # simulate a detector: every camera "detects" the canopy-height scene
    # center (a small box around its projected pixel)
    cams = MetashapeCameraSet(
        survey["cameras_file"], survey["image_folder"], validate_images=False
    )
    mesh = TexturedMesh(
        survey["mesh_file"], transform_filename=survey["cameras_file"],
        device=device,
    )
    verts_local = mesh.get_verts_in_local_frame(cams)
    target = verts_local.mean(axis=0)
    target[2] = verts_local[:, 2].max()
    xy, _d, valid = project_points(
        cams.get_camera_batch(device=device),
        torch.as_tensor(target[None], dtype=torch.float32, device=device),
    )
    xy, valid = xy.cpu().numpy(), valid.cpu().numpy()
    det_dir = out / "detections"
    det_dir.mkdir(parents=True, exist_ok=True)
    for i in range(len(cams)):
        if not valid[i, 0]:
            continue
        x, y = float(xy[i, 0, 0]), float(xy[i, 0, 1])
        box = Polygon(
            np.array([[x - 3, y - 3], [x + 3, y - 3], [x + 3, y + 3],
                      [x - 3, y + 3]])
        )
        VectorData([box], {"label": ["tree"]}).to_file(
            det_dir / f"img_{i:04d}.geojson"
        )
    points = multiview_detections(
        mesh_file=survey["mesh_file"],
        cameras_file=survey["cameras_file"],
        image_folder=survey["image_folder"],
        detections_folder=det_dir,
        similarity_threshold_meters=2.0,
        covering_mesh_N=8,
        triangulated_points_savefile=out / "triangulated_points.geojson",
        device=device,
    )
    print(f"   triangulated {len(points)} object location(s)")

    print("5. visualize: top-down composite")
    from geograypher_tpu_torch.entrypoints.visualize import visualize

    visualize(
        mesh_file=survey["mesh_file"],
        cameras_file=survey["cameras_file"],
        image_folder=survey["image_folder"],
        screenshot_filename=out / "overview.png",
        device=device,
    )
    print(f"done; products in {out}/")


if __name__ == "__main__":
    main(*sys.argv[1:3])
