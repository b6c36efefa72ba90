"""What decides ``correct`` in the render cell: a sound run passes; the
control (the reference's masks in bfloat16 written in the program's place)
and each fault a render cell can have, planted under a whole run, fail:
no mask written (a survey that leaves its state unchanged), half the views
left out, and a mask altered where it is produced."""

import time

import numpy as np
import pytest
import torch

from benchmark import cells, harness
from benchmark.reference import raster as reference
from geograypher_tpu_torch.utils.io import write_image

CELL = "tin1m-4k-brown.render-masks"
render = cells.plugin("entries", "render")
_sound = render.RenderSystem.survey


def _run(cell, seed=2**31 + 13):
    return harness.run(cell, seed, 0.1, False, "cpu", time.perf_counter())


def _cell(small_cell):
    cell = small_cell(CELL)
    cell.config["views_per_survey"] = 4
    cell.traffic["views_per_survey"] = 4
    cell.traffic["check_masks"] = 4
    return cell


def test_a_sound_run_is_correct(small_cell):
    out = _run(_cell(small_cell))
    assert out["correct"], out["checks"]
    assert out["metrics"]["render_masks_per_s"]["value"] > 0


def _control(self, survey, folder):
    img = self.config["image"]
    v = torch.as_tensor(self.mesh_verts)
    fc = torch.as_tensor(self.mesh_faces).long()
    tex = torch.as_tensor(self.texture_in).to(torch.bfloat16)
    for k in range(len(survey)):
        mask = reference.render_mask(v, fc, tex, survey.c2w[k],
                                     self.config["sensors"][survey.sensor[k]],
                                     img["width"], img["height"], torch.bfloat16)
        write_image(folder / render.mask_name(k), mask.numpy())


def _nothing(self, survey, folder):
    return None


def _half(self, survey, folder):
    _sound(self, survey, folder)
    for k in range(1, len(survey), 2):
        (folder / render.mask_name(k)).unlink()


def _altered(self, survey, folder):
    from benchmark.reference import png

    _sound(self, survey, folder)
    path = folder / render.mask_name(0)
    mask = png.decode(path.read_bytes())
    write_image(path, np.where(mask == 255, 255, (mask + 1) % 4).astype(np.uint8))


@pytest.mark.parametrize("fault", [_control, _nothing, _half, _altered],
                         ids=["control_bfloat16", "state_unchanged", "half_the_views",
                              "answer_altered"])
def test_a_broken_path_is_not_correct(small_cell, monkeypatch, fault):
    keep = render.RenderSystem.__init__

    def init(self, verts, faces, texture, *args, **kwargs):
        keep(self, verts, faces, texture, *args, **kwargs)
        self.mesh_verts, self.mesh_faces, self.texture_in = verts, faces, texture

    monkeypatch.setattr(render.RenderSystem, "__init__", init)
    monkeypatch.setattr(render.RenderSystem, "survey", fault)
    out = _run(_cell(small_cell))
    assert not out["correct"], out["checks"]
