"""Survey aggregation: ``aggregate_class_images_distributed`` over surveys
of the configuration's views, and its check against the plain reference.

The mix names the label source (``labels/<labels>.py``), the label pool
and its squares, and the keyword arguments of the pipeline call
(``pipeline``); the configuration and the mix together give the raster
configuration.  The compared numbers, with their limits in ``LIMITS``:
``view_count_gap`` = sum |view counts - reference| / sum reference view
counts, and ``fraction_gap`` = sum |fraction sums - reference| / sum
reference view counts, faces matched through the program's face order.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import cells, roofline, scene, system
from benchmark.reference import raster as reference
from geograypher_tpu_torch.meshes.mesh import TexturedMesh
from geograypher_tpu_torch.parallel import pipeline

LIMITS = {"view_count_gap": 0.01, "fraction_gap": 0.01}


class AggregateSystem:
    """The mesh on the device, spatially sorted as a user sorts it, and one
    survey at a time through ``aggregate_class_images_distributed``."""

    def __init__(self, verts, faces, config: dict, traffic: dict, device: torch.device):
        self.mesh = TexturedMesh((verts, faces),
                                 raster_config=system.raster_config(config, traffic),
                                 device=device)
        self.order = self.mesh.spatial_sort_faces()
        self.config, self.traffic = config, traffic
        self.source = cells.plugin("labels", traffic["labels"])
        self.prepared = None  # the label pool as the label source hands it over
        self.device = device
        self.stats = system.PipelineStats().attach()

    def survey(self, survey):
        """(fraction_sums, view_counts) of one survey, as the program
        returns them."""
        img = self.config["image"]
        cams = system.camera_set(survey, self.config["sensors"], img["width"],
                                 img["height"])
        cams, provider = self.source.route(cams, self.prepared, survey.label)
        with record_function("bench.survey"):
            return pipeline.aggregate_class_images_distributed(
                self.mesh, cams, self.config["n_classes"],
                class_image_provider=provider, device_mesh=[self.device],
                **self.traffic.get("pipeline", {}))

    def release(self):
        """Drop the program's state, so that the reference finds the memory."""
        self.stats.detach()
        self.mesh = self.prepared = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class Entry:
    """Surveys of the configuration's views (the mix's ``views_per_survey``
    where it gives one), labels drawn from a seeded pool of int8 class
    images constant over ``label_patch``-pixel squares."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        img = config["image"]
        self.width, self.height = img["width"], img["height"]
        self.n_classes = config["n_classes"]
        self.sensors = config["sensors"]
        self.views_per_survey = traffic.get("views_per_survey",
                                            config["views_per_survey"])
        self.verts, self.faces = scene.make_mesh(config["mesh"])
        self.system = AggregateSystem(self.verts, self.faces, config, traffic,
                                      self.device)
        self.stats = self.system.stats
        self._last = (None, None)
        self.reseed(seed)

    def reseed(self, seed: int):
        """Make the label pool of ``seed`` and draw later surveys from it;
        the mesh, a deployment's, stays."""
        self.seed = seed
        self.labels = scene.label_pool(
            self.traffic["label_pool"], self.height, self.width, self.n_classes,
            self.traffic["label_patch"], scene.rng(seed, scene.STREAM_LABELS))
        self.system.prepared = self.system.source.prepare(self.labels, self.n_classes)

    def survey_of(self, index: int) -> scene.Survey:
        """Survey ``index`` of the window (-1: the warm-up survey)."""
        gen = (scene.rng(self.seed, scene.STREAM_WARMUP) if index < 0
               else scene.rng(self.seed, scene.STREAM_SURVEY, index))
        return scene.survey(self.config["views"], self.sensors, self.width,
                            self.views_per_survey, len(self.labels), gen)

    def run(self, index: int) -> scene.Done:
        survey = self.survey_of(index)
        return scene.Done(index, survey, self.system.survey(survey))

    def reference(self, done: scene.Done, dtype=torch.float64):
        """The plain reference's (fraction sums, view counts) of a survey;
        the last float64 one is kept, so that the control does not redo it."""
        key = (self.seed, done.index)
        if dtype != torch.float64 or self._last[0] != key:
            out = reference.aggregate(
                self.verts, self.faces, done.survey, self.sensors, self.labels,
                self.width, self.height, self.n_classes, self.device, dtype)
            if dtype != torch.float64:
                return out
            self._last = (key, out)
        return self._last[1]

    def check(self, done: scene.Done) -> dict:
        """The gaps between the program's survey and the reference's."""
        return gaps(done.result, self.reference(done), self.system.order)

    def control(self, done: scene.Done, dtype) -> dict:
        """The gaps of the reference computed in ``dtype`` in the
        program's place."""
        return gaps(self.reference(done, dtype), self.reference(done),
                    np.arange(len(self.faces)))

    def least_seconds(self, surveys: list) -> float:
        """The roofline's least time of every view of ``surveys``."""
        return sum(roofline.survey_least_seconds(
            self.verts, self.faces, d.survey, self.sensors, self.width, self.height,
            self.n_classes, self.device) for d in surveys)

    def release(self):
        self.system.release()

    def close(self):
        pass


def gaps(program, ref, order) -> dict:
    """The compared numbers of a survey: ``program`` (fraction sums, view
    counts) with face i the mesh's face ``order[i]``, ``ref`` the same in
    the mesh's own face order."""
    sums, counts = (np.asarray(a, np.float64) for a in program)
    order = np.asarray(order)
    if not np.array_equal(np.sort(order), np.arange(len(ref[1]))):
        raise ValueError("the program's face order is not a permutation of the faces")
    ref_sums, ref_counts = ref[0][order], ref[1][order]
    total = max(float(ref_counts.sum()), 1.0)
    if sums.shape != ref_sums.shape or counts.shape != ref_counts.shape:
        return {"view_count_gap": float("inf"), "fraction_gap": float("inf")}
    return {"view_count_gap": float(np.abs(counts - ref_counts).sum()) / total,
            "fraction_gap": float(np.abs(sums - ref_sums).sum()) / total}
