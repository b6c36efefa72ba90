"""Rendering training masks: ``TexturedMesh.save_renders`` over surveys of
the configuration's views, and its check against the plain reference.

The mix names the survey size, the seeded polygons that give the faces
their classes, and the masks checked.  The compared numbers, with their
limits in ``LIMITS``: ``mask_gap``, the share of the sampled masks'
pixels that differ from the reference's, and ``masks_missing``, the share
of sampled views with no readable file of the right size.
"""

from __future__ import annotations

import shutil
import tempfile
from pathlib import Path

import torch
from torch.profiler import record_function

from benchmark import scene, system
from benchmark.reference import png
from benchmark.reference import raster as reference
from geograypher_tpu_torch.meshes.mesh import TexturedMesh

LIMITS = {"mask_gap": 0.002, "masks_missing": 0.0}


def mask_name(view: int) -> str:
    """The file a survey's view ``view`` is rendered to."""
    return f"view_{view:04d}.png"


class RenderSystem:
    """The textured mesh on the device, spatially sorted, and one survey at
    a time through ``TexturedMesh.save_renders``."""

    def __init__(self, verts, faces, texture, config: dict, traffic: dict,
                 device: torch.device):
        self.mesh = TexturedMesh((verts, faces), texture=texture[:, None],
                                 raster_config=system.raster_config(config, traffic),
                                 device=device)
        self.order = self.mesh.spatial_sort_faces()
        self.config, self.device = config, device

    def survey(self, survey, folder):
        """Render every view of ``survey`` to ``folder``, a PNG mask a view
        named by :func:`mask_name`."""
        img = self.config["image"]
        cams = system.camera_set(survey, self.config["sensors"], img["width"],
                                 img["height"], names=[mask_name(k)
                                                       for k in range(len(survey))])
        with record_function("bench.save_renders"):
            self.mesh.save_renders(cams, output_folder=folder)

    def release(self):
        self.mesh = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class Entry:
    """Surveys of the configuration's views (the mix's ``views_per_survey``
    where it gives one), per-face classes from seeded polygons; every
    survey's PNG files into a folder of its own under ``TMPDIR``, removed
    when the run ends."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        img = config["image"]
        self.width, self.height = img["width"], img["height"]
        self.sensors = config["sensors"]
        self.views_per_survey = traffic.get("views_per_survey",
                                            config["views_per_survey"])
        self.verts, self.faces = scene.make_mesh(config["mesh"])
        self.folder = Path(tempfile.mkdtemp(prefix="bench-renders-"))
        self.stats = system.PipelineStats()  # save_renders logs no pipeline_stats
        self.system = None
        self.reseed(seed)

    def reseed(self, seed: int):
        """Make the face classes of ``seed`` and the program's textured
        mesh; later surveys are drawn from ``seed``."""
        self.seed = seed
        polygons = scene.label_polygons(
            self.config["views"]["scene_width"], self.traffic["polygons"],
            self.traffic["polygon_radius"], scene.rng(seed, scene.STREAM_LABELS))
        self.texture = scene.face_classes(self.verts, self.faces, polygons)
        if self.system is not None:
            self.system.release()
        self.system = RenderSystem(self.verts, self.faces, self.texture, self.config,
                                   self.traffic, self.device)

    def survey_of(self, index: int) -> scene.Survey:
        gen = (scene.rng(self.seed, scene.STREAM_WARMUP) if index < 0
               else scene.rng(self.seed, scene.STREAM_SURVEY, index))
        return scene.survey(self.config["views"], self.sensors, self.width,
                            self.views_per_survey, 1, gen)

    def run(self, index: int) -> scene.Done:
        survey = self.survey_of(index)
        folder = self.folder / f"survey_{index + 1}"
        self.system.survey(survey, folder)
        return scene.Done(index, survey, folder)

    def _sample(self, done: scene.Done):
        k = self.traffic["check_masks"]
        pick = scene.rng(self.seed, scene.STREAM_SAMPLE, done.index).permutation(len(done.survey))
        return sorted(pick[:k].tolist())

    def reference(self, done: scene.Done, views, dtype=torch.float64) -> list:
        """The plain reference's masks of ``views`` of a survey."""
        v = torch.as_tensor(self.verts, device=self.device)
        fc = torch.as_tensor(self.faces, device=self.device).long()
        tex = torch.as_tensor(self.texture, device=self.device).to(dtype)
        return [reference.render_mask(v, fc, tex, done.survey.c2w[k],
                                      self.sensors[done.survey.sensor[k]], self.width,
                                      self.height, dtype).cpu().numpy()
                for k in views]

    def check(self, done: scene.Done) -> dict:
        """The sampled masks' gaps from the reference's."""
        views = self._sample(done)
        masks = []
        for k in views:
            try:
                masks.append(png.decode((done.result / mask_name(k)).read_bytes()))
            except (OSError, ValueError):
                masks.append(None)
        return mask_gaps(masks, self.reference(done, views))

    def control(self, done: scene.Done, dtype) -> dict:
        views = self._sample(done)
        return mask_gaps(self.reference(done, views, dtype), self.reference(done, views))

    def least_seconds(self, surveys: list):
        """None: the render chain's least time is not counted yet."""
        return None

    def release(self):
        self.system.release()

    def close(self):
        shutil.rmtree(self.folder, ignore_errors=True)


def mask_gaps(masks: list, ref: list) -> dict:
    """The compared numbers of sampled masks (see :meth:`Entry.check`)."""
    missing = differ = pixels = 0
    for mask, want in zip(masks, ref):
        pixels += want.size
        if mask is None or mask.shape != want.shape:
            missing += 1
            differ += want.size
        else:
            differ += int((mask != want).sum())
    return {"mask_gap": differ / max(pixels, 1), "masks_missing": missing / max(len(ref), 1)}
