"""The least time the card could take for a view of the survey chain.

It counts the work from what the user hands over and what the survey
returns, never from the program's intermediates, so it reads the same
whatever kernels implement the chain:

* bytes: the mesh read once (vertices (V, 3) float32, faces (F, 3)
  int32), the view's labels read once ((H, W) int8), and the survey's
  (F, C) + (F,) float32 accumulators written once, shared out over its
  views;
* operations: ``FLOP_PER_CAND_PIXEL`` for every pixel in the clipped
  pixel-centre box of every face in front of the camera (three edge
  planes and the 1/z plane, each a*x + b*y + c), by the benchmark's own
  projection (``reference/raster.py``).

The least time is the larger of bytes over the HBM rate and operations
over the float32 rate outside the tensor cores of one H100 SXM (NVIDIA's
data sheet, at its 700 W limit).
"""

from __future__ import annotations

import torch

from benchmark.reference import raster

HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
FLOP_PER_CAND_PIXEL = 16


def view_bytes(n_verts: int, n_faces: int, width: int, height: int,
               n_classes: int, survey_views: int) -> float:
    """Bytes one view of a survey of ``survey_views`` views must move."""
    mesh = n_verts * 3 * 4 + n_faces * 3 * 4
    labels = width * height
    accumulators = (n_faces * n_classes + n_faces) * 4
    return mesh + labels + accumulators / survey_views


def view_flop(verts: torch.Tensor, faces: torch.Tensor, c2w, sensor: dict,
              width: int, height: int) -> float:
    """Operations of one view: ``FLOP_PER_CAND_PIXEL`` times the pixels of
    the clipped boxes of the faces in front of the camera (``verts``
    (V, 3), ``faces`` (F, 3) int64, on one device)."""
    w2c, f, cx, cy, dist = raster.camera_params(c2w, sensor)
    sx, sy, _, ok = raster.project(verts, w2c, f, cx, cy, dist, width, height)
    boxes = raster.face_boxes(sx, sy, ok, faces, width, height)
    return FLOP_PER_CAND_PIXEL * float(raster.candidate_pixels(boxes))


def least_seconds(n_bytes: float, n_flop: float) -> float:
    """The roofline's least time of ``n_bytes`` and ``n_flop``."""
    return max(n_bytes / HBM_BYTES_S, n_flop / FP32_FLOP_S)


def survey_least_seconds(verts, faces, survey, sensors: list, width: int,
                         height: int, n_classes: int, device="cpu") -> float:
    """The least time of every view of ``survey`` together (``verts``,
    ``faces`` as numpy; the projection runs on ``device``)."""
    v = torch.as_tensor(verts, device=device)
    fc = torch.as_tensor(faces, device=device).long()
    n_bytes = view_bytes(len(verts), len(faces), width, height, n_classes, len(survey))
    return sum(least_seconds(n_bytes, view_flop(v, fc, survey.c2w[k],
                                                sensors[survey.sensor[k]], width,
                                                height))
               for k in range(len(survey)))
