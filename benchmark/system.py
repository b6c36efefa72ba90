"""The system under test, the PyTorch and CUDA port: what every entry
shares in driving it.

The entries (``entries/*.py``), the label sources (``labels/*.py``) and
this module are the harness's only modules that import the program.  This
one reads the program's counters (each kernel wrapper's ``launches`` and
the survey pipeline's ``pipeline_stats`` log record), builds the
program's cameras from a survey, and its raster configuration from data.
"""

from __future__ import annotations

import dataclasses
import logging

from geograypher_tpu_torch.cameras.core import CameraSet
from geograypher_tpu_torch.meshes.mesh import DEFAULT_RASTER_CONFIG
from geograypher_tpu_torch.ops import (
    binning,
    face_counts,
    face_sums,
    onehot,
    raster_tiles,
    subtile,
    tri_setup,
)
from geograypher_tpu_torch.parallel import pipeline

COUNTED = {"triangle_setup": tri_setup, "tile_binning": binning,
           "raster_tiles": raster_tiles, "face_class_counts": face_counts,
           "onehot_class": onehot, "face_sums": face_sums, "s_raster": subtile}


def launches() -> dict:
    """Every kernel wrapper's launch counter, by kernel."""
    return {name: module.launches for name, module in COUNTED.items()}


class PipelineStats(logging.Handler):
    """The ``pipeline_stats`` of the survey pipeline's log records, from
    :meth:`attach` to :meth:`detach`."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        stats = getattr(record, "pipeline_stats", None)
        if stats is not None:
            self.records.append(stats)

    def attach(self):
        log = logging.getLogger(pipeline.__name__)
        log.setLevel(logging.INFO)
        log.addHandler(self)
        return self

    def detach(self):
        logging.getLogger(pipeline.__name__).removeHandler(self)


def camera_set(survey, sensors: list, width: int, height: int,
               names=None) -> CameraSet:
    """A survey's cameras as the program's ``CameraSet`` (``names``: the
    views' image file names)."""
    intrinsics = {
        k: {"f": s["f"], "cx": s.get("cx", 0.0), "cy": s.get("cy", 0.0),
            "image_width": width, "image_height": height,
            **({"distortion_params": dict(s["distortion"])} if s.get("distortion")
               else {})}
        for k, s in enumerate(sensors)}
    return CameraSet(list(survey.c2w), intrinsics, image_filenames=names,
                     sensor_IDs=[int(k) for k in survey.sensor])


def raster_config(config: dict, traffic: dict):
    """The library's default raster configuration with every field the
    configuration's ``raster`` and then the mix's ``raster`` set (lists
    become tuples)."""
    fields = {**config.get("raster", {}), **traffic.get("raster", {})}
    return dataclasses.replace(
        DEFAULT_RASTER_CONFIG,
        **{k: tuple(v) if isinstance(v, list) else v for k, v in fields.items()})
