"""Camera views dealt over a list of devices, in PyTorch.

Port of ``geograypher_tpu/parallel/sharding.py``.  The JAX package shards
the views of one process over its local devices with ``shard_map``; the
port does the same with a tuple of ``torch.device``s in one process and
one thread:

* the mesh geometry and the face texture are REPLICATED, one copy a
  device;
* views are dealt over the devices, padded to a multiple of their count
  with a validity mask;
* each device accumulates its own per-face state, and the per-device
  states are summed onto the first device in device order (JAX's
  ``psum``), a fixed order, so two runs give the same bits.

Every launch comes from the calling thread, so the kernels of all
devices are queued in one fixed order.  ``unrolled_view_scan`` is a
Mosaic workaround and has no counterpart: a Python loop is the loop.
A device list may name one device more than once (two shards on one
card run the cross-device sum's code path); real multi-GPU runs are
untested.
"""

from __future__ import annotations

import typing
from typing import Tuple

import numpy as np
import torch

from geograypher_tpu_torch.ops.aggregate import (
    accumulate_view,
    init_aggregation,
    project_image_to_faces,
    render_texture,
)
from geograypher_tpu_torch.ops.rasterize import (
    RasterConfig,
    rasterize_triangles,
    transform_to_camera,
)
from geograypher_tpu_torch.utils.device import resolve_device

ViewMesh = Tuple[torch.device, ...]


def make_view_mesh(devices: typing.Optional[typing.Sequence] = None) -> ViewMesh:
    """The devices views are dealt over, in order.  Default: every CUDA
    device; raises when there is no card, never falling back to the CPU.
    ``devices=["cpu", "cpu"]`` gives two CPU shards."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_view_mesh() needs a CUDA device and "
                "torch.cuda.is_available() is False; pass devices=['cpu'] "
                "to run on the CPU"
            )
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    mesh = tuple(resolve_device(d, "make_view_mesh") for d in devices)
    if not mesh:
        raise ValueError("make_view_mesh: no devices")
    return mesh


def pad_views(n_views: int, n_devices: int) -> int:
    """Views padded so every device gets an equal batch."""
    return -(-n_views // n_devices) * n_devices


def sum_over_devices(parts: typing.Sequence[torch.Tensor]) -> torch.Tensor:
    """The per-device tensors summed onto the first one's device, in
    device order (the fixed order of JAX's ``psum`` here)."""
    total = parts[0]
    for part in parts[1:]:
        total = total + part.to(total.device)
    return total


def shard_views_for_mesh(
    world_to_cam: np.ndarray,
    focals: np.ndarray,
    mesh: ViewMesh,
) -> Tuple[list, list, list]:
    """Pad the view arrays to a device multiple (identity transforms,
    focal 1) and cut them into one slice a device: ``(w2c, f, valid)``,
    three lists of float32 tensors, each entry on its device, ``valid``
    0 on the padding views."""
    n = world_to_cam.shape[0]
    n_dev = len(mesh)
    n_pad = pad_views(n, n_dev)
    w2c = np.concatenate(
        [np.asarray(world_to_cam, np.float64),
         np.broadcast_to(np.eye(4), (n_pad - n, 4, 4))], axis=0)
    f = np.concatenate([np.asarray(focals, np.float64),
                        np.full((n_pad - n,), 1.0)])
    valid = np.concatenate([np.ones(n), np.zeros(n_pad - n)])
    per = n_pad // n_dev

    def cut(a):
        return [torch.as_tensor(a[d * per:(d + 1) * per], dtype=torch.float32,
                                device=dev) for d, dev in enumerate(mesh)]

    return cut(w2c), cut(f), cut(valid)


def sharded_render_aggregate(
    tri_verts,
    face_texture,
    world_to_cam: list,
    focals: list,
    view_valid: list,
    *,
    image_w: int,
    image_h: int,
    n_faces: int,
    config: RasterConfig,
    mesh: ViewMesh,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every device renders the face texture into its views through the
    raster chain, folds each view's pixels back onto the faces
    (``project_image_to_faces``, the ``face_sums`` kernels on the card)
    and accumulates them with ``accumulate_view``; the per-device
    accumulators are summed onto the first device in device order.

    A self-contained render -> aggregate round trip (the parity oracle of
    the multi-device path).  Views are launched in turn over the devices,
    view k of every device before view k + 1.

    Args:
        tri_verts: (F, 3, 3) triangles in the local frame (numpy or a
            tensor), copied to every device.
        face_texture: (F, C) per-face texture, copied to every device.
        world_to_cam, focals, view_valid: one (V_d, 4, 4), (V_d,), (V_d,)
            tensor a device (:func:`shard_views_for_mesh`).

    Returns ``(value_sum (F, C), view_count (F,))`` on the first device:
    the summed per-view means and the views that saw each face.  Raises
    after the last view, naming each (device, view) whose tile lists
    dropped candidates, when any did: the overflow is read once.
    """
    if not (len(world_to_cam) == len(focals) == len(view_valid) == len(mesh)):
        raise ValueError(f"{len(world_to_cam)} view shards for {len(mesh)} devices")
    tri = {dev: torch.as_tensor(tri_verts, dtype=torch.float32).to(dev)
           for dev in set(mesh)}
    tex = {dev: torch.as_tensor(face_texture, dtype=torch.float32).to(dev)
           for dev in set(mesh)}
    n_channels = tex[mesh[0]].shape[1]
    states = [init_aggregation(n_faces, n_channels, dev) for dev in mesh]
    overflows = []  # (device, view, dropped candidates on the device)
    for k in range(max(len(f) for f in focals)):
        for d, dev in enumerate(mesh):
            if k >= len(focals[d]):
                continue
            cam_tris = transform_to_camera(tri[dev], world_to_cam[d][k])
            p2f, overflow = rasterize_triangles(
                cam_tris, focals[d][k], image_w, image_h, config,
                return_overflow=True)
            valid = view_valid[d][k]
            # a padding view's drops do not reach the aggregate
            overflows.append((d, k, overflow * (valid != 0)))
            sums, counts = project_image_to_faces(
                p2f, render_texture(p2f, tex[dev]), n_faces)
            states[d] = accumulate_view(states[d], sums * valid, counts * valid)
    # one read of every view's overflow, after the last launch
    dropped = torch.stack([o.to(mesh[0]) for _, _, o in overflows]).cpu().tolist()
    over = [(d, k, int(n)) for (d, k, _), n in zip(overflows, dropped) if n]
    if over:
        raise RuntimeError(
            f"raster capacity overflow in views (device, view, dropped) {over}: "
            f"their tile lists at caps {tuple(config.caps)} dropped candidates, "
            "so the aggregate is incomplete. Pass a RasterConfig with larger caps."
        )
    return (sum_over_devices([s.value_sum for s in states]),
            sum_over_devices([s.view_count for s in states]))
