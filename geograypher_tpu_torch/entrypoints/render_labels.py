"""render_labels: rasterize geospatial ground-truth labels into each
camera view as training masks.

Port of ``geograypher_tpu/entrypoints/render_labels.py``, same argument
surface plus ``device`` and ``raster_config``: texture the mesh from a
vector label file (or an array, a .npy file, a scalar of the mesh file),
crop mesh and cameras to the labeled region, render per-camera masks with
occlusion-correct z-buffering on ``device`` and save them as PNG files
named after the images; with ``n_cameras_per_chunk``, camera cluster by
camera cluster, each from its own buffered sub-mesh
(``meshes/chunked.py``).  With a DTM, labelled vertices less than
``ground_height_threshold`` above it are relabelled to a ground class
(rendered with ``render_ground_class``, else left unlabelled).  With
``make_composites`` every mask whose view has an image also gets a
``<stem>_composite.png`` beside it (label | image | overlay), on the
chunked route as well.  ``vis`` is accepted and, as in the JAX package,
read nowhere.
"""

from __future__ import annotations

import argparse
import shutil
import typing
from pathlib import Path

import numpy as np

from geograypher_tpu_torch.cameras.metashape import MetashapeCameraSet
from geograypher_tpu_torch.constants import PATH_TYPE
from geograypher_tpu_torch.meshes.chunked import render_flat_chunked
from geograypher_tpu_torch.meshes.mesh import DEFAULT_RASTER_CONFIG, TexturedMesh
from geograypher_tpu_torch.ops.rasterize import RasterConfig
from geograypher_tpu_torch.utils.files import ensure_folder
from geograypher_tpu_torch.utils.io import write_image
from geograypher_tpu_torch.utils.visualization import save_composite

VECTOR_SUFFIXES = (".geojson", ".json", ".gpkg", ".shp")


def render_labels(
    mesh_file: PATH_TYPE,
    cameras_file: PATH_TYPE,
    image_folder: PATH_TYPE,
    texture: typing.Union[PATH_TYPE, np.ndarray],
    render_savefolder: PATH_TYPE,
    mesh_CRS: typing.Optional[int] = None,
    original_image_folder: typing.Optional[PATH_TYPE] = None,
    subset_images_savefolder: typing.Optional[PATH_TYPE] = None,
    texture_column_name: typing.Optional[str] = None,
    DTM_file: typing.Optional[PATH_TYPE] = None,
    ground_height_threshold: typing.Optional[float] = 2.0,
    render_ground_class: bool = False,
    textured_mesh_savefile: typing.Optional[PATH_TYPE] = None,
    ROI: typing.Optional[PATH_TYPE] = None,
    ROI_buffer_radius_meters: float = 50,
    cameras_ROI_buffer_radius_meters: typing.Optional[float] = None,
    IDs_to_labels: typing.Optional[dict] = None,
    render_image_scale: float = 1.0,
    mesh_downsample: float = 1.0,
    n_cameras_per_chunk: typing.Optional[int] = None,
    save_native_resolution: bool = True,
    make_composites: bool = False,
    vis: bool = False,
    raster_config: typing.Optional[RasterConfig] = None,
    device="cuda",
):
    """Render geospatial labels into each camera as per-pixel masks.

    Arguments as in ``geograypher_tpu.entrypoints.render_labels``.
    ``device`` is where the per-view work runs (the card by default).
    ``raster_config`` replaces the mesh's default tile-list capacities: a
    view that overflows them raises after the last view, and larger
    ``caps`` are the remedy.  Returns (mesh, camera_set).
    """
    del vis  # accepted as the JAX package accepts it, and read nowhere
    camera_set = MetashapeCameraSet(
        cameras_file,
        image_folder,
        original_image_folder=original_image_folder,
        validate_images=False,
    )

    # infer the ROI from the texture's extent when not given
    effective_roi = ROI
    if effective_roi is None and isinstance(texture, (str, Path)):
        if Path(texture).suffix.lower() in VECTOR_SUFFIXES:
            effective_roi = texture

    if effective_roi is not None:
        cam_buffer = (
            cameras_ROI_buffer_radius_meters
            if cameras_ROI_buffer_radius_meters is not None
            else ROI_buffer_radius_meters
        )
        camera_set = camera_set.get_subset_ROI(effective_roi, cam_buffer)
        if subset_images_savefolder is not None:
            ensure_folder(subset_images_savefolder)
            for i in range(len(camera_set)):
                src = camera_set.get_image_filename(i)
                if src is not None and src.exists():
                    shutil.copy(src, subset_images_savefolder)

    mesh = TexturedMesh(
        mesh_file,
        downsample_target=mesh_downsample,
        CRS=mesh_CRS,
        transform_filename=cameras_file,
        texture=texture,
        texture_column_name=texture_column_name,
        ROI=effective_roi,
        ROI_buffer_meters=ROI_buffer_radius_meters,
        IDs_to_labels=IDs_to_labels,
        raster_config=raster_config or DEFAULT_RASTER_CONFIG,
        device=device,
    )

    if DTM_file is not None and ground_height_threshold is not None:
        mesh.label_ground_class(
            DTM_file,
            height_above_ground_threshold=ground_height_threshold,
            ground_ID=None if render_ground_class else np.nan,
            only_label_existing=True,
        )

    if textured_mesh_savefile is not None:
        mesh.save_mesh(textured_mesh_savefile)

    if n_cameras_per_chunk is not None:
        # the JAX package's chunked writer: the first channel, NaN -> 255,
        # at the render's scale
        for img, cam in render_flat_chunked(
            mesh,
            camera_set,
            n_cameras_per_chunk=n_cameras_per_chunk,
            render_img_scale=render_image_scale,
        ):
            fname = cam.image_filenames[0]
            out = (Path(render_savefolder)
                   / (fname.name if fname else "render.png")).with_suffix(".png")
            data = np.where(np.isfinite(img[..., 0]), img[..., 0], 255.0)
            write_image(out, np.clip(data, 0, 255).astype(np.uint8))
            if make_composites and fname is not None and fname.exists():
                save_composite(img[..., 0], fname,
                               out.with_name(out.stem + "_composite.png"),
                               mesh.IDs_to_labels)
    else:
        mesh.save_renders(
            camera_set,
            render_image_scale=render_image_scale,
            output_folder=render_savefolder,
            save_native_resolution=save_native_resolution,
            make_composites=make_composites,
        )
    return mesh, camera_set


def parse_args():
    parser = argparse.ArgumentParser(
        description=render_labels.__doc__,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--mesh-file", required=True)
    parser.add_argument("--cameras-file", required=True)
    parser.add_argument("--image-folder", required=True)
    parser.add_argument("--texture", required=True)
    parser.add_argument("--render-savefolder", required=True)
    parser.add_argument("--mesh-CRS", type=int, default=None)
    parser.add_argument("--original-image-folder", default=None)
    parser.add_argument("--texture-column-name", default=None)
    parser.add_argument("--DTM-file", default=None)
    parser.add_argument("--ground-height-threshold", type=float, default=2.0)
    parser.add_argument("--render-ground-class", action="store_true")
    parser.add_argument("--ROI", default=None)
    parser.add_argument("--ROI-buffer-radius-meters", type=float, default=50)
    parser.add_argument("--render-image-scale", type=float, default=1.0)
    parser.add_argument("--mesh-downsample", type=float, default=1.0)
    parser.add_argument("--n-cameras-per-chunk", type=int, default=None)
    parser.add_argument("--device", default="cuda")
    return parser.parse_args()


if __name__ == "__main__":
    render_labels(**vars(parse_args()))
