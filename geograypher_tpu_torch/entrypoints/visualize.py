"""visualize: a quick look at a mesh and its cameras.

Port of ``geograypher_tpu/entrypoints/visualize.py``.  The orthographic
pix2face of the mesh runs on ``device`` (the card by default) through the
raster chain (``TexturedMesh.ortho_pix2face``); the value map the JAX
version draws with matplotlib (each pixel the texture value of the face it
sees, 1 where the mesh has no texture, NaN off the mesh) is coloured here
with the port's viridis table over its finite range, NaN white, with the
cameras' positions marked red, and written as a PNG.  It returns that
(H, W, 3) uint8 RGB image where the JAX version returns a matplotlib
``Figure``.  With ``export_html`` it also writes the interactive WebGL
viewer of the mesh and the camera frustums.
"""

from __future__ import annotations

import argparse
import time
import typing

import numpy as np

from geograypher_tpu_torch.cameras.metashape import MetashapeCameraSet
from geograypher_tpu_torch.constants import PATH_TYPE
from geograypher_tpu_torch.meshes.mesh import TexturedMesh
from geograypher_tpu_torch.parallel.planner import census_caps
from geograypher_tpu_torch.utils import crs as crs_utils
from geograypher_tpu_torch.utils.colormaps import colormap
from geograypher_tpu_torch.utils.io import write_image

CAMERA_RGB = (255, 0, 0)
CAMERA_MARK_PX = 1  # a camera is a (2 * CAMERA_MARK_PX + 1) px square


def value_map_image(values: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a value map: viridis over its finite range
    (the table's first colour when the range is one value), NaN white."""
    finite = np.isfinite(values)
    rgb = np.ones(values.shape + (3,))
    if finite.any():
        lo, hi = np.nanmin(values), np.nanmax(values)
        norm = (values - lo) / (hi - lo) if hi > lo else np.zeros_like(values)
        rgb[finite] = colormap("viridis", norm[finite])[:, :3]
    return np.round(rgb * 255).astype(np.uint8)


def mark_points(image: np.ndarray, xy: np.ndarray, bounds, color=CAMERA_RGB,
                half: int = CAMERA_MARK_PX) -> np.ndarray:
    """Paint ``xy`` (N, 2) map coordinates onto an image spanning
    ``bounds`` (x0, y0, x1, y1; row 0 at y1) as small squares."""
    h, w = image.shape[:2]
    x0, y0, x1, y1 = bounds
    cols = np.floor((xy[:, 0] - x0) / (x1 - x0) * w).astype(np.int64)
    rows = np.floor((y1 - xy[:, 1]) / (y1 - y0) * h).astype(np.int64)
    for r, c in zip(rows, cols):
        if -half <= r < h + half and -half <= c < w + half:
            image[max(r - half, 0):r + half + 1, max(c - half, 0):c + half + 1] = color
    return image


def visualize(
    mesh_file: PATH_TYPE,
    cameras_file: typing.Optional[PATH_TYPE] = None,
    image_folder: typing.Optional[PATH_TYPE] = None,
    mesh_CRS: typing.Optional[int] = None,
    texture: typing.Optional[PATH_TYPE] = None,
    texture_column_name: typing.Optional[str] = None,
    mesh_downsample: float = 1.0,
    screenshot_filename: typing.Optional[PATH_TYPE] = None,
    resolution_m: float = 0.5,
    export_html: typing.Optional[PATH_TYPE] = None,
    device="cuda",
    stats: typing.Optional[dict] = None,
) -> np.ndarray:
    """Top-down image of the mesh's texture and the camera positions;
    with ``export_html`` also the interactive viewer (mesh and frustums).

    Arguments as in the JAX package's function.  The ortho's tile-list
    caps are sized by a census of its tiles, so it never overflows.
    ``stats``, when given, gets the value map (``values``), its ``bounds``
    and ``epsg``, the ``census`` and the ``caps`` it ran at, and the
    seconds of the load (``load_s``), the census (``census_s``), the
    ortho (``ortho_s``, the census included) and the HTML export
    (``html_s``).  Returns the (H, W, 3) uint8 image.
    """
    stats = {} if stats is None else stats
    t0 = time.perf_counter()
    mesh = TexturedMesh(
        mesh_file,
        downsample_target=mesh_downsample,
        CRS=mesh_CRS,
        transform_filename=cameras_file,
        texture=texture,
        texture_column_name=texture_column_name,
        device=device,
    )
    tex = mesh.get_texture(request_vertex_texture=False)
    if tex is not None and tex.ndim == 2 and tex.shape[1] > 1:
        tex = np.nanargmax(np.nan_to_num(tex), axis=1).astype(float)
    t1 = time.perf_counter()
    census = mesh.ortho_raster_census(mesh.ortho_plan(resolution_m=resolution_m))
    mesh.raster_config = census_caps(census, mesh.raster_config)
    t_census = time.perf_counter()
    p2f, bounds, crs = mesh.ortho_pix2face(resolution_m=resolution_m)
    t2 = time.perf_counter()
    if tex is not None:
        vals = np.asarray(tex).reshape(-1)
        values = np.where(p2f >= 0, vals[np.clip(p2f, 0, None)], np.nan)
    else:
        values = np.where(p2f >= 0, 1.0, np.nan)
    image = value_map_image(values)
    cams = None
    if cameras_file is not None and image_folder is not None:
        cams = MetashapeCameraSet(cameras_file, image_folder)
        lls = cams.get_lon_lat_coords()
        if lls and lls[0] is not None and crs is not None:
            lla = np.array([[ll[1], ll[0], 0.0] for ll in lls])
            image = mark_points(image, crs_utils.transform_points(lla, 4326, crs),
                                bounds)
    t3 = time.perf_counter()
    if export_html is not None:
        mesh.export_html_viewer(export_html, cameras=cams)
    t4 = time.perf_counter()
    if screenshot_filename is not None:
        write_image(screenshot_filename, image)
    stats.update(values=values, bounds=bounds, epsg=crs, census=census,
                 caps=tuple(mesh.raster_config.caps), load_s=t1 - t0,
                 census_s=t_census - t1, ortho_s=t2 - t1, html_s=t4 - t3)
    return image


def parse_args():
    parser = argparse.ArgumentParser(
        description=visualize.__doc__,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--mesh-file", required=True)
    parser.add_argument("--cameras-file", default=None)
    parser.add_argument("--image-folder", default=None)
    parser.add_argument("--mesh-CRS", type=int, default=None)
    parser.add_argument("--texture", default=None)
    parser.add_argument("--texture-column-name", default=None)
    parser.add_argument("--mesh-downsample", type=float, default=1.0)
    parser.add_argument("--screenshot-filename", default=None)
    parser.add_argument("--export-html", default=None)
    parser.add_argument("--device", default="cuda")
    return parser.parse_args()


if __name__ == "__main__":
    visualize(**vars(parse_args()))
