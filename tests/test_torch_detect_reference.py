"""The port's sparse detection path against the benchmark's plain
reference (``benchmark/reference/detect.py``) on the CPU: seeded crown
boxes written as DeepForest CSV tables, read by
``TabularRectangleSegmentor``, projected by ``aggregate_index_predictions``
at scale 0.25 through Brown-Conrady lenses, and labelled by
``sparse_argmax``.

On a grid, a height field that no view sees a face of twice, the
counts, the views that see each face and the labels equal the
reference's through pinhole sensors, and through the lens they differ
only where the warp's map lies on a half pixel (at scale 0.25 the map
samples the sensor at 4 i + 2, which the centre of the lens leaves on
the half pixel i + 1/2, so float32 and float64 round it apart); on a TIN the gaps stay within the detection cell's limits;
the reference in bfloat16, put in the program's place, fails one.  The
painting rule is held pixel for pixel where boxes overlap and where they
cross the frame's edge."""

import json
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse
import torch

from benchmark import cells, scene, system
from benchmark.reference import detect as reference
from geograypher_tpu_torch.cameras.segmentor_set import SegmentorCameraSet
from geograypher_tpu_torch.meshes import sparse
from geograypher_tpu_torch.meshes.mesh import TexturedMesh
from geograypher_tpu_torch.parallel.planner import census_caps
from geograypher_tpu_torch.predictors.segmentors import TabularRectangleSegmentor
from tests.test_torch_rasterize import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "benchmark/configs/tin1m-6k-treedet.json").read_text())
entry = cells.plugin("entries", "detect")
WIDTH, HEIGHT = 768, 512  # a 192 x 128 raster at the configuration's scale
SCALE = CONFIG["aggregate_image_scale"]
SENSORS = [dict(s, f=s["f"] * WIDTH / CONFIG["image"]["width"])
           for s in CONFIG["sensors"]]
PINHOLE = [dict(s, distortion={}) for s in SENSORS]
# crowns large and close enough for their boxes to overlap
CROWNS = dict(CONFIG["crowns"], count=30, radius_m=[0.12, 0.22], spacing_m=0.12)
MESHES = {"grid": {"kind": "grid", "n": 36, "size": 4.0, "z_amplitude": 0.1,
                   "z_frequency": 3.0},
          "tin": dict(CONFIG["mesh"], n_points=1600)}


def _survey(tmp_path, kind, seed, sensors=SENSORS, views=5):
    """A seeded survey over the ``kind`` mesh: (verts, faces, survey,
    tables folder, image names, sensors)."""
    verts, faces = scene.make_mesh(MESHES[kind])
    gen = scene.rng(seed, scene.STREAM_SURVEY)
    survey = scene.survey(CONFIG["views"], sensors, WIDTH, views, 1, gen)
    centres, radii = entry.crowns(verts, faces, CROWNS, gen)
    folder = tmp_path / "tables"
    rows = entry.write_tables(folder, survey, centres, radii, sensors, WIDTH, HEIGHT,
                              0.1, gen)
    assert rows > 5 * views
    return (verts, faces, survey, folder, [entry.image_name(k) for k in range(views)],
            sensors)


def _program(verts, faces, survey, folder, names, sensors, **kwargs):
    """The port's (counts CSR, views seeing each face, labels), the caps
    sized by the census as the detection cell sizes them (``kwargs`` to
    ``aggregate_index_predictions``)."""
    mesh = TexturedMesh((verts, faces), device="cpu")
    cams = system.camera_set(survey, sensors, WIDTH, HEIGHT, names=names)
    mesh.raster_config = census_caps(mesh.view_raster_census(cams, SCALE),
                                     mesh.raster_config)
    detector = TabularRectangleSegmentor(folder, image_shape=(HEIGHT, WIDTH))
    counts, seen = sparse.aggregate_index_predictions(
        mesh, SegmentorCameraSet(cams, detector), detector.num_classes,
        aggregate_img_scale=SCALE, **kwargs)
    return counts, seen, sparse.sparse_argmax(counts)


def _reference(verts, faces, survey, folder, names, sensors, dtype=torch.float64):
    tables = reference.read_tables(folder)
    n_det = sum(len(ids) for _, ids in tables.values())
    rows, seen = reference.project(verts, faces, survey, sensors, names, tables,
                                   WIDTH, HEIGHT, SCALE, "cpu", dtype)
    counts = scipy.sparse.csr_array((rows[:, 2].astype(float), (rows[:, 0], rows[:, 1])),
                                    shape=(len(faces), n_det))
    return counts, seen, reference.labels(rows, len(faces))


def _half_pixel_reads(survey, folder, names, sensors) -> int:
    """Painted pixels of the survey whose float64 lens map lies within
    1e-4 px of a half pixel: those float32 may round apart."""
    tables = reference.read_tables(folder)
    total = 0
    for k in range(len(survey)):
        s = sensors[survey.sensor[k]]
        dist = [s["distortion"].get(key, 0.0) for key in
                ("k1", "k2", "k3", "k4", "p1", "p2", "b1", "b2")]
        rows, cols = reference.ideal_of_warped_scaled(WIDTH, HEIGHT, s["f"], 0.0, 0.0,
                                                      dist, SCALE, "cpu", torch.float64)
        edge = ((rows - rows.floor() - 0.5).abs() < 1e-4) | (
            (cols - cols.floor() - 0.5).abs() < 1e-4)
        painted = reference.paint(*tables[names[k]], HEIGHT, WIDTH, SCALE, "cpu") >= 0
        total += int((edge & painted).sum())
    return total


@pytest.mark.parametrize("lens", [False, True], ids=["pinhole", "brown"])
def test_grid_counts_seen_and_labels_equal_the_reference(tmp_path, lens):
    inputs = _survey(tmp_path, "grid", 2**31 + 3, SENSORS if lens else PINHOLE)
    counts, seen, labels = _program(*inputs)
    ref_counts, ref_seen, ref_labels = _reference(*inputs)
    assert ref_counts.nnz > 1000 and np.isfinite(ref_labels).sum() > 100
    moved = abs(counts.astype(np.float64) - ref_counts).sum()
    if not lens:
        assert moved == 0
        np.testing.assert_array_equal(seen, ref_seen)
        np.testing.assert_array_equal(labels, ref_labels)
        assert entry.gaps((counts, seen, labels), (ref_counts, ref_seen, ref_labels)) == {
            "count_gap": 0.0, "seen_gap": 0.0, "label_gap": 0.0}
        return
    edge = _half_pixel_reads(*inputs[2:])
    assert edge > 0
    assert moved <= 2 * edge  # a pixel read apart moves one count out, one in
    gaps = entry.gaps((counts, seen, labels), (ref_counts, ref_seen, ref_labels))
    assert all(gaps[name] <= limit for name, limit in entry.LIMITS.items()), gaps
    assert np.abs(seen - ref_seen).sum() <= edge
    labelled = np.isfinite(ref_labels)
    assert (labels[labelled] != ref_labels[labelled]).sum() <= edge


@pytest.mark.parametrize("seed", [7, 2**31 + 5])
def test_tin_within_the_cells_limits_and_the_control_fails_one(tmp_path, seed):
    inputs = _survey(tmp_path, "tin", seed)
    ref = _reference(*inputs)
    assert ref[0].nnz > 1000
    sound = entry.gaps(_program(*inputs), ref)
    assert all(sound[name] <= limit for name, limit in entry.LIMITS.items()), sound
    control = entry.gaps(_reference(*inputs, dtype=torch.bfloat16), ref)
    assert any(control[name] > limit for name, limit in entry.LIMITS.items()), control


def _paint_program(tmp_path, rows, height, width):
    path = tmp_path / "boxes.csv"
    lines = ["image_path,xmin,ymin,xmax,ymax,label"]
    lines += [f"a.JPG,{x0},{y0},{x1},{y1},Tree" for x0, y0, x1, y1 in rows]
    path.write_text("\n".join(lines) + "\n")
    seg = TabularRectangleSegmentor(path, image_shape=(height, width))
    img = seg.segment_image(None, filename="a.JPG", image_scale=SCALE)
    return np.where(np.isfinite(img), img, -1).astype(np.int64), path


def test_painting_rule_where_boxes_overlap_and_cross_the_edge(tmp_path):
    height, width = 203, 311  # neither divides by 4: the scaled sizes truncate
    gen = np.random.default_rng(11)
    x0 = gen.uniform(-40, width - 10, 60)
    y0 = gen.uniform(-40, height - 10, 60)
    # every box reaches into the frame, as a detector's do: one that ends
    # left of or above it would be a negative slice end for the segmentor
    x1 = np.maximum(x0 + gen.uniform(3, 90, 60), gen.uniform(4, 30, 60))
    y1 = np.maximum(y0 + gen.uniform(3, 90, 60), gen.uniform(4, 30, 60))
    rows = np.stack([x0, y0, x1, y1], 1)
    rows[-4:] = [[-7.9, -3.3, 40.2, 22.7], [300.5, 190.1, 340.0, 260.0],
                 [10.0, 10.0, 60.0, 60.0], [30.0, 30.0, 80.0, 50.0]]  # edges, overlap
    want, path = _paint_program(tmp_path, rows, height, width)
    tables = reference.read_tables(path.parent)
    boxes, ids = tables["a.JPG"]
    got = reference.paint(boxes, ids, height, width, SCALE, "cpu").numpy()
    assert got.shape == (int(height * SCALE), int(width * SCALE))
    np.testing.assert_array_equal(got, want)
    # the later of the two overlapping boxes wins where they overlap
    assert got[10, 10] == 59 and got[8, 5] == 58
    assert (got[0, :10] == 56).all() and (got[-1, -2:] == 57).all()
    # rows in a file's order, the ids over the files in the order of their names
    (tmp_path / "c_second.csv").write_text(
        "image_path,xmin,ymin,xmax,ymax,label\nb.JPG,0,0,8,8,Tree\n")
    tables = reference.read_tables(tmp_path)
    assert tables["b.JPG"][1].tolist() == [len(rows)]
