"""Under-canopy mesh painting with a 360-degree camera rig, on the port.

Mirrors the reference's undercanopy_painting notebook on a synthetic
survey (no external data needed): ground-level equirectangular captures
are fanned out into a six-member perspective rig
(``create_rig_cameras_from_equirectangular``), per-image semantic
predictions are aggregated onto the mesh with occlusion-correct
z-buffering, and the recovered per-face labels are compared against the
known ground truth.

The mesh keeps the JAX script's fixed tile-list caps (1024, 128, 64, 32).
The port raises where a view overflows its caps (the JAX package drops the
overflow silently); no rig view of this survey overflows them, so they are
not sized by a census here.

    python examples_torch/undercanopy_painting.py [output_folder] [device]

``device`` is the card by default (the script raises without one);
``cpu`` runs it on the CPU.
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent.parent))


def main(out="undercanopy_out", device=None):
    import torch

    from geograypher_tpu_torch.utils.device import resolve_device

    device = resolve_device("cuda" if device is None else device,
                            "undercanopy_painting.main")
    out = Path(out)

    print("1. generating synthetic under-canopy 360 survey...")
    from geograypher_tpu_torch.utils.example_data import create_undercanopy_survey

    survey = create_undercanopy_survey(out / "survey", n_stations=3,
                                       device=device)
    n_classes = survey["n_classes"]

    print("2. building the perspective rig camera set...")
    from geograypher_tpu_torch.cameras.rig import (
        create_rig_cameras_from_equirectangular,
    )

    rig_set = create_rig_cameras_from_equirectangular(
        camera_file=survey["cameras_file"],
        original_images=survey["equirect_folder"],
        perspective_images=survey["prediction_folder"],
        rig_camera=survey["rig_camera"],
        rig_orientations=survey["rig_orientations"],
        perspective_filename_format_str=survey["format_str"],
    )
    print(f"   {len(rig_set)} rig cameras from "
          f"{len(rig_set) // len(survey['rig_orientations'])} stations")

    print("3. loading the mesh (ROI-cropped around the stations)...")
    from geograypher_tpu_torch.meshes.mesh import TexturedMesh
    from geograypher_tpu_torch.ops.rasterize import RasterConfig

    mesh = TexturedMesh(
        survey["mesh_file"],
        transform_filename=survey["cameras_file"],
        raster_config=RasterConfig(caps=(1024, 128, 64, 32)),
        device=device,
    )

    print("4. aggregating per-image predictions onto the mesh...")
    from geograypher_tpu_torch.cameras.segmentor_set import SegmentorCameraSet
    from geograypher_tpu_torch.ops.aggregate import find_argmax_nonzero_value
    from geograypher_tpu_torch.predictors.segmentors import LookUpSegmentor

    segmentor = LookUpSegmentor(
        base_folder=survey["prediction_folder"],
        lookup_folder=survey["prediction_folder"],
        num_classes=n_classes,
    )
    seg_set = SegmentorCameraSet(rig_set, segmentor)
    averaged, _info = mesh.aggregate_projected_images(seg_set)
    face_classes = find_argmax_nonzero_value(torch.as_tensor(averaged)).numpy()

    truth = survey["face_labels"].astype(float)
    seen = np.isfinite(face_classes)
    acc = float(np.mean(face_classes[seen] == truth[seen]))
    print(f"   recovered {acc:.1%} of {int(seen.sum())} observed faces "
          f"({len(truth)} total)")

    print("5. exporting the labeled mesh + per-class summary...")
    out_npy = out / "aggregated_face_labels.npy"
    out_npy.parent.mkdir(parents=True, exist_ok=True)
    np.save(out_npy, averaged)
    labeled = np.where(seen, face_classes, np.nan)
    for c in range(n_classes):
        n = int(np.sum(labeled == c))
        if n:
            print(f"   class {c}: {n} faces")
    print(f"   wrote {out_npy}")
    return acc


if __name__ == "__main__":
    main(*sys.argv[1:3])
