"""The chain's least time is a function of the mesh, the camera and the
survey's size alone, and equals a hand count on a two-triangle scene."""

import numpy as np
import pytest
import torch

from benchmark import roofline, scene


def _scene():
    # a unit square at z = 0 split into two triangles, seen from 10 m
    # straight above through a 100 x 60 px image at f = 50 px: the square
    # spans 5 px, x in [47.5, 52.5], y in [27.5, 32.5]
    verts = np.array([[-0.5, -0.5, 0.0], [0.5, -0.5, 0.0], [0.5, 0.5, 0.0],
                      [-0.5, 0.5, 0.0]])
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return verts, faces, scene.nadir_c2w(10.0), {"f": 50.0}


def test_two_triangles_by_hand():
    verts, faces, c2w, sensor = _scene()
    flop = roofline.view_flop(torch.as_tensor(verts), torch.as_tensor(faces).long(),
                              c2w, sensor, 100, 60)
    # each face's box spans pixel centres 47.5..52.5 on both axes: 6 x 6
    assert flop == 16 * 2 * 36
    n_bytes = roofline.view_bytes(4, 2, 100, 60, 10, survey_views=4)
    assert n_bytes == 4 * 12 + 2 * 12 + 6000 + (2 * 10 + 2) * 4 / 4
    survey = scene.Survey(c2w[None], np.zeros(1, int), np.zeros(1, int))
    least = roofline.survey_least_seconds(verts, faces, survey, [sensor], 100, 60, 10)
    bytes_one = 4 * 12 + 2 * 12 + 6000 + (2 * 10 + 2) * 4
    assert least == pytest.approx(max(bytes_one / 3.35e12, 16 * 72 / 67e12))


def test_faces_behind_or_outside_count_nothing():
    verts, faces, c2w, sensor = _scene()
    behind = verts + np.array([0.0, 0.0, 20.0])
    flop = roofline.view_flop(torch.as_tensor(behind), torch.as_tensor(faces).long(),
                              c2w, sensor, 100, 60)
    assert flop == 0
    aside = verts + np.array([40.0, 0.0, 0.0])
    assert roofline.view_flop(torch.as_tensor(aside), torch.as_tensor(faces).long(),
                              c2w, sensor, 100, 60) == 0
