"""Render geospatial field labels into each camera's pixel frame, on the
port.

Mirrors the reference's render_labels notebook on a synthetic survey (no
external data needed): the mesh is textured from a vector file of labeled
polygons (ROI-cropped around them), ground faces are labeled against the
DTM, the labeled mesh is saved, and per-camera label masks are rendered at
native resolution -- the training-data generation direction of the
framework.

    python examples_torch/render_labels.py [output_folder] [device]

``device`` is the card by default (the script raises without one);
``cpu`` runs it on the CPU.
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent.parent))

# Notebook knobs
HEIGHT_ABOVE_GROUND_THRESH = 2.0
RENDER_IMAGE_SCALE = 1.0
MESH_BUFFER_RADIUS_METER = 20.0
CAMERAS_BUFFER_RADIUS_METERS = 100.0


def main(out="render_labels_out", device=None):
    from geograypher_tpu_torch.utils.device import resolve_device

    device = resolve_device("cuda" if device is None else device,
                            "render_labels.main")
    out = Path(out)

    print("1. generating synthetic survey...")
    from geograypher_tpu_torch.utils.example_data import create_example_survey

    survey = create_example_survey(out / "survey", n_cameras=6, sensor=128,
                                   device=device)
    n_classes = survey["n_classes"]
    ids_to_labels = {k: f"object_{k}" for k in range(1, n_classes)}

    print("2. texturing the mesh from the labeled polygons (ROI-cropped)...")
    from geograypher_tpu_torch.meshes.mesh import TexturedMesh

    mesh = TexturedMesh(
        survey["mesh_file"],
        transform_filename=survey["cameras_file"],
        texture=survey["labels_vector_file"],
        texture_column_name="species",
        ROI=survey["labels_vector_file"],
        ROI_buffer_meters=MESH_BUFFER_RADIUS_METER,
        IDs_to_labels=ids_to_labels,
        device=device,
    )

    print("3. labeling ground faces against the DTM...")
    mesh.label_ground_class(
        DTM_file=survey["dtm_file"],
        height_above_ground_threshold=HEIGHT_ABOVE_GROUND_THRESH,
        only_label_existing_labels=True,
        ground_class_name="GROUND",
        ground_ID=np.nan,  # ground pixels render unlabeled
        set_mesh_texture=True,
    )

    labeled_mesh_file = out / "labeled_mesh.ply"
    print(f"4. saving the labeled mesh to {labeled_mesh_file}...")
    mesh.save_mesh(labeled_mesh_file)

    print("5. rendering label masks for the training cameras...")
    from geograypher_tpu_torch.cameras.metashape import MetashapeCameraSet

    camera_set = MetashapeCameraSet(
        survey["cameras_file"], survey["image_folder"]
    )
    training_camera_set = camera_set.get_subset_ROI(
        ROI=survey["labels_vector_file"],
        buffer_radius=CAMERAS_BUFFER_RADIUS_METERS,
    )
    render_folder = out / "rendered_labels"
    mesh.save_renders(
        training_camera_set,
        render_image_scale=RENDER_IMAGE_SCALE,
        save_native_resolution=True,
        output_folder=render_folder,
    )
    n_rendered = len(list(render_folder.rglob("*.png")))
    print(f"   rendered {n_rendered} label masks")

    print("6. composite overview of renders vs images...")
    from geograypher_tpu_torch.utils.visualization import show_segmentation_labels

    show_segmentation_labels(
        label_folder=render_folder,
        image_folder=survey["image_folder"],
        savefolder=out / "label_vis",
        num_show=4,
    )
    print(f"done; products in {out}/")
    return n_rendered


if __name__ == "__main__":
    main(*sys.argv[1:3])
