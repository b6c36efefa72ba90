"""Carry state across from the JAX package into the port.

This system has no model weights: its state is the mesh, the cameras and
the raster configuration.  These functions read the JAX objects'
attributes only (numpy arrays and plain Python values) and import
nothing from ``geograypher_tpu`` at module level, so the port can be
held against the JAX package on identical state.
"""

from __future__ import annotations

import numpy as np

from geograypher_tpu_torch.cameras.core import CameraSet
from geograypher_tpu_torch.cameras.segmentor_set import SegmentorCameraSet
from geograypher_tpu_torch.meshes.mesh import TexturedMesh
from geograypher_tpu_torch.ops.rasterize import RasterConfig


def raster_config_from_jax(cfg) -> RasterConfig:
    """The port's RasterConfig with a JAX ``RasterConfig``'s fields.

    The TPU-only tuning fields are dropped; a level-S ``subtile`` setting
    is refused because level S is not ported yet.
    """
    if getattr(cfg, "subtile", None) is not None:
        raise NotImplementedError(
            "the level-S sub-tile raster (RasterConfig.subtile) is not "
            "ported yet (ROADMAP A10, kernels B5/B6)"
        )
    return RasterConfig(
        tile_h=cfg.tile_h,
        tile_w=cfg.tile_w,
        level_scales=tuple(cfg.level_scales),
        caps=tuple(cfg.caps),
        chunk=cfg.chunk,
        znear=cfg.znear,
        bin_block=cfg.bin_block,
        l0_window=cfg.l0_window,
        global_from=cfg.global_from,
    )


def mesh_from_jax(tmesh, device="cpu") -> TexturedMesh:
    """A port TexturedMesh holding a JAX TexturedMesh's geometry, CRS,
    raster config and face/vertex textures (as numpy)."""
    out = TexturedMesh(
        (np.array(tmesh.verts), np.array(tmesh.faces)),
        IDs_to_labels=tmesh.IDs_to_labels,
        raster_config=raster_config_from_jax(tmesh.raster_config),
        device=device,
    )
    out.CRS = tmesh.CRS
    for name in ("vertex_texture", "face_texture"):
        tex = getattr(tmesh, name)
        setattr(out, name, None if tex is None else np.array(tex))
    return out


def cameras_from_jax(camset) -> CameraSet:
    """A port CameraSet with a JAX CameraSet's transforms, sensors and
    metadata; a JAX SegmentorCameraSet keeps its (framework-free)
    segmentor."""
    if hasattr(camset, "segmentor") and hasattr(camset, "base"):
        return SegmentorCameraSet(cameras_from_jax(camset.base), camset.segmentor)
    out = CameraSet.__new__(CameraSet)
    out.cam_to_world_transforms = [
        np.array(t, dtype=np.float64) for t in camset.cam_to_world_transforms
    ]
    out.image_filenames = list(camset.image_filenames)
    out.lon_lats = list(camset.lon_lats)
    out.sensor_IDs = list(camset.sensor_IDs)
    out.sensors = {k: (None if v is None else dict(v))
                   for k, v in camset.sensors.items()}
    out.image_folder = camset.image_folder
    t = camset.local_to_epsg_4978_transform
    out.local_to_epsg_4978_transform = None if t is None else np.array(t)
    out._batch_cache = {}
    return out
