"""render_height_masks: render each camera's height above a DTM.

Port of ``geograypher_tpu/entrypoints/render_height_masks.py``, same
argument surface plus ``device`` and ``raster_config``: the mesh's
per-vertex height above the digital terrain model (``DTM_file``, a
GeoTIFF) is thresholded into {0: ground, 1: low, 2: canopy} and rendered
into every camera as uint8 PNG masks, or with ``binary_masks=False``
rendered as it is into float32 ``.npy`` files (NaN where no face is
seen), on ``device`` through the raster chain (``save_renders``).
"""

from __future__ import annotations

import argparse
import typing

import numpy as np

from geograypher_tpu_torch.cameras.metashape import MetashapeCameraSet
from geograypher_tpu_torch.constants import PATH_TYPE
from geograypher_tpu_torch.meshes.mesh import DEFAULT_RASTER_CONFIG, TexturedMesh
from geograypher_tpu_torch.ops.rasterize import RasterConfig


def render_height_masks(
    mesh_file: PATH_TYPE,
    cameras_file: PATH_TYPE,
    image_folder: PATH_TYPE,
    DTM_file: PATH_TYPE,
    render_savefolder: PATH_TYPE,
    mesh_CRS: typing.Optional[int] = None,
    original_image_folder: typing.Optional[PATH_TYPE] = None,
    ground_threshold: typing.Optional[float] = 2.0,
    canopy_threshold: typing.Optional[float] = None,
    binary_masks: bool = True,
    render_image_scale: float = 1.0,
    mesh_downsample: float = 1.0,
    take_every_nth_camera: typing.Optional[int] = None,
    raster_config: typing.Optional[RasterConfig] = None,
    device="cuda",
):
    """Per-camera height masks: thresholded {0: ground, 1: low, 2:
    canopy} uint8 masks, or raw float height-above-ground renders.
    Arguments as in ``geograypher_tpu.entrypoints.render_height_masks``;
    ``device`` is where the per-view work runs (the card by default) and
    ``raster_config`` the tile-list capacities (a view that overflows
    them writes no file and the call raises).  Returns the mesh."""
    camera_set = MetashapeCameraSet(
        cameras_file,
        image_folder,
        original_image_folder=original_image_folder,
        validate_images=False,
    )
    if take_every_nth_camera is not None:
        camera_set = camera_set.get_subset_every_nth(take_every_nth_camera)
    mesh = TexturedMesh(
        mesh_file,
        downsample_target=mesh_downsample,
        CRS=mesh_CRS,
        transform_filename=cameras_file,
        raster_config=raster_config or DEFAULT_RASTER_CONFIG,
        device=device,
    )
    hag = mesh.get_height_above_ground(DTM_file)
    if binary_masks:
        tex = np.zeros_like(hag)
        if ground_threshold is not None:
            tex[hag >= ground_threshold] = 1.0
        if canopy_threshold is not None:
            tex[hag >= canopy_threshold] = 2.0
        mesh.set_texture(tex, is_vertex=True)
        mesh.save_renders(
            camera_set,
            render_image_scale=render_image_scale,
            output_folder=render_savefolder,
        )
    else:
        mesh.set_texture(hag, is_vertex=True)
        mesh.save_renders(
            camera_set,
            render_image_scale=render_image_scale,
            output_folder=render_savefolder,
            cast_to_uint8=False,
            output_extension=".npy",
        )
    return mesh


def parse_args():
    parser = argparse.ArgumentParser(
        description=render_height_masks.__doc__,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--mesh-file", required=True)
    parser.add_argument("--cameras-file", required=True)
    parser.add_argument("--image-folder", required=True)
    parser.add_argument("--DTM-file", required=True)
    parser.add_argument("--render-savefolder", required=True)
    parser.add_argument("--mesh-CRS", type=int, default=None)
    parser.add_argument("--ground-threshold", type=float, default=2.0)
    parser.add_argument("--canopy-threshold", type=float, default=None)
    parser.add_argument(
        "--binary-masks",
        action=argparse.BooleanOptionalAction,
        default=True,
        help="thresholded uint8 masks (--no-binary-masks: raw "
        "height-above-ground .npy renders)",
    )
    parser.add_argument("--render-image-scale", type=float, default=1.0)
    parser.add_argument("--mesh-downsample", type=float, default=1.0)
    parser.add_argument("--take-every-nth-camera", type=int, default=None)
    parser.add_argument("--device", default="cuda")
    return parser.parse_args()


if __name__ == "__main__":
    render_height_masks(**vars(parse_args()))
