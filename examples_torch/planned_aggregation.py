"""Flagship planned aggregation through the public mesh API, on the port.

Demonstrates ``TexturedMesh.aggregate_class_images_planned`` -- the
census-bucketed multi-view plan (parallel/planner.py) -- on a synthetic
Metashape-style survey, and checks its pooled-count argmax against the
reference-semantics view-weighted average from
``aggregate_projected_images``.

    python examples_torch/planned_aggregation.py [output_folder] [device]

``device`` is the card by default (the script raises without one);
``cpu`` runs it on the CPU.
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent.parent))


def main(out="planned_aggregation_out", device=None):
    from geograypher_tpu_torch.utils.device import resolve_device

    device = resolve_device("cuda" if device is None else device,
                            "planned_aggregation.main")
    out = Path(out)

    print("1. generating synthetic survey...")
    from geograypher_tpu_torch.utils.example_data import create_example_survey

    survey = create_example_survey(out / "survey", n_cameras=8, sensor=128,
                                   device=device)
    n_classes = survey["n_classes"]

    print("2. loading mesh + cameras...")
    from geograypher_tpu_torch.cameras.metashape import MetashapeCameraSet
    from geograypher_tpu_torch.cameras.segmentor_set import SegmentorCameraSet
    from geograypher_tpu_torch.meshes.mesh import TexturedMesh
    from geograypher_tpu_torch.predictors.segmentors import LookUpSegmentor

    mesh = TexturedMesh(
        survey["mesh_file"], transform_filename=survey["cameras_file"],
        device=device,
    )
    mesh.spatial_sort_faces()  # serpentine face order: compact fold windows
    cameras = MetashapeCameraSet(
        survey["cameras_file"], survey["image_folder"]
    )
    segmentor = LookUpSegmentor(
        base_folder=survey["image_folder"],
        lookup_folder=survey["label_folder"],
        num_classes=n_classes,
    )
    seg_cameras = SegmentorCameraSet(cameras, segmentor)

    print("3. planned aggregation (census -> buckets -> grouped programs)...")
    counts, plan = mesh.aggregate_class_images_planned(
        seg_cameras, n_classes, max_buckets=2, group=4
    )
    print(
        f"   {plan.n_views} views in {len(plan.buckets)} bucket(s); "
        f"census+sizing {plan.plan_seconds:.2f}s; "
        f"{int((counts.sum(axis=1) > 0).sum())} faces observed"
    )

    print("4. cross-checking against aggregate_projected_images...")
    avg, info = mesh.aggregate_projected_images(seg_cameras)
    observed = info["projection_counts"] > 0
    pred_planned = np.argmax(counts, axis=1)
    pred_avg = np.nanargmax(np.nan_to_num(avg, nan=-1.0), axis=1)
    agree = (pred_planned[observed] == pred_avg[observed]).mean()
    print(f"   argmax agreement on observed faces: {agree:.4f}")
    if agree < 0.95:
        raise SystemExit(
            "pooled-count argmax diverged from the view-weighted average"
        )

    np.save(out / "planned_counts.npy", counts)
    print(f"done -> {out}")


if __name__ == "__main__":
    main(*sys.argv[1:3])
