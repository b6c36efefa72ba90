"""Aggregate per-image ML predictions onto the mesh and score them, on the
port.

Mirrors the reference's aggregate_predictions notebook on a synthetic
survey (no external data needed): precomputed label images are served by
a ``LookUpSegmentor``, aggregated across views onto mesh faces with
occlusion-correct z-buffering, ground faces are masked out against the
DTM, per-polygon labels are derived from the faces, and a confusion matrix
+ comprehensive metrics are computed against the ground-truth vector file.

The confusion matrix is written as ``confusion_matrix.png``: one 32 px
square a cell, coloured by the port's viridis table (``utils/colormaps.py``)
at the cell's count over the largest count, true classes on rows and
predicted ones on columns.  ``compute_and_show_cf`` is called without
``savefile``: its plot needs matplotlib, which the card's machine does not
have, and the image here needs none.  It has no axis labels or colour bar.

    python examples_torch/aggregate_predictions.py [output_folder] [device]

``device`` is the card by default (the script raises without one);
``cpu`` runs it on the CPU.
"""

import pprint
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent.parent))

# Processing parameters (mirroring the notebook's knobs)
HEIGHT_ABOVE_GROUND_THRESH = 0.5  # meters above the DTM to count as canopy
#                                   (the synthetic objects are 1-3 m tall;
#                                   the notebook uses 2 m on real forest)
AGGREGATE_IMAGE_SCALE = 1.0  # synthetic images are tiny; the reference
#                              uses 0.25 on its 4K captures
CF_CELL_PX = 32  # side of a confusion-matrix cell in its image


def confusion_matrix_image(cf):
    """(n * CF_CELL_PX, n * CF_CELL_PX, 3) uint8 viridis image of ``cf``."""
    from geograypher_tpu_torch.utils.colormaps import colormap

    cf = np.asarray(cf, dtype=np.float64)
    scaled = cf / max(cf.max(), 1.0)
    rgb = colormap("viridis", scaled)[..., :3]
    rgb = np.repeat(np.repeat(rgb, CF_CELL_PX, axis=0), CF_CELL_PX, axis=1)
    return np.round(rgb * 255).astype(np.uint8)


def main(out="aggregate_predictions_out", device=None):
    import torch

    from geograypher_tpu_torch.utils.device import resolve_device

    device = resolve_device("cuda" if device is None else device,
                            "aggregate_predictions.main")
    out = Path(out)

    print("1. generating synthetic survey (mesh, cameras, predictions)...")
    from geograypher_tpu_torch.utils.example_data import create_example_survey

    survey = create_example_survey(out / "survey", n_cameras=6, sensor=128,
                                   device=device)
    n_classes = survey["n_classes"]
    # the survey's face labels: ground = 0, objects = 1..n (the GeoJSON's
    # species strings are object_1..object_n)
    ids_to_labels = {0: "ground"}
    ids_to_labels.update(
        {k: f"object_{k}" for k in range(1, n_classes)}
    )

    print("2. loading the mesh + camera set...")
    from geograypher_tpu_torch.cameras.metashape import MetashapeCameraSet
    from geograypher_tpu_torch.meshes.mesh import TexturedMesh

    mesh = TexturedMesh(
        survey["mesh_file"],
        transform_filename=survey["cameras_file"],
        IDs_to_labels=ids_to_labels,
        device=device,
    )
    camera_set = MetashapeCameraSet(
        survey["cameras_file"], survey["image_folder"]
    )
    # restrict to cameras near the labeled region, like the notebook's
    # get_subset_ROI(ROI=LABELS_FILENAME, buffer_radius=...)
    camera_set = camera_set.get_subset_ROI(
        ROI=survey["labels_vector_file"], buffer_radius=100.0
    )
    print(f"   {len(camera_set)} cameras near the labeled region")

    print("3. aggregating predicted label images onto mesh faces...")
    from geograypher_tpu_torch.cameras.segmentor_set import SegmentorCameraSet
    from geograypher_tpu_torch.ops.aggregate import find_argmax_nonzero_value
    from geograypher_tpu_torch.predictors.segmentors import LookUpSegmentor

    segmentor = LookUpSegmentor(
        base_folder=survey["image_folder"],
        lookup_folder=survey["label_folder"],
        num_classes=n_classes,
    )
    segmentor_camera_set = SegmentorCameraSet(camera_set, segmentor)
    aggregated_face_labels, _ = mesh.aggregate_projected_images(
        segmentor_camera_set, aggregate_img_scale=AGGREGATE_IMAGE_SCALE
    )
    np.save(out / "aggregated_face_labels.npy", aggregated_face_labels)

    print("4. argmax + ground masking against the DTM...")
    predicted_face_classes = find_argmax_nonzero_value(
        torch.as_tensor(aggregated_face_labels), keepdims=True
    ).numpy()
    predicted_face_classes, _ = mesh.label_ground_class(
        labels=predicted_face_classes,
        height_above_ground_threshold=HEIGHT_ABOVE_GROUND_THRESH,
        DTM_file=survey["dtm_file"],
        ground_ID=np.nan,
        set_mesh_texture=False,
    )

    print("5. labeling the ground-truth polygons from the faces...")
    from geograypher_tpu_torch.utils.vector import VectorData

    polygons = VectorData.read_file(survey["labels_vector_file"])
    predicted_polygon_labels = mesh.label_polygons(
        face_labels=predicted_face_classes,
        polygons=polygons,
    )
    # map integer class IDs back to label strings where needed
    predicted_polygon_labels = [
        ids_to_labels.get(p, p) if not isinstance(p, str) else p
        for p in predicted_polygon_labels
    ]

    print("6. scoring against the ground truth...")
    from geograypher_tpu_torch.utils.io import write_image
    from geograypher_tpu_torch.utils.prediction_metrics import (
        compute_and_show_cf,
        compute_comprehensive_metrics,
    )

    ground_truth = list(polygons.attributes["species"])
    # drop the ground class, like the notebook: no polygon is labeled it
    all_classes = [ids_to_labels[k] for k in range(1, n_classes)]
    cf_matrix, _, accuracy = compute_and_show_cf(
        pred_labels=predicted_polygon_labels,
        gt_labels=ground_truth,
        labels=all_classes,
    )
    write_image(out / "confusion_matrix.png", confusion_matrix_image(cf_matrix))
    print(f"   accuracy was {accuracy}")
    metrics = compute_comprehensive_metrics(cf_matrix)
    print("   comprehensive metrics:")
    pprint.PrettyPrinter(indent=2).pprint(metrics)
    print(f"done; products in {out}/")
    return accuracy


if __name__ == "__main__":
    main(*sys.argv[1:3])
