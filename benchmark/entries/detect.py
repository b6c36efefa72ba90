"""Tree-crown detections projected onto the mesh: the functions
``project_detections`` calls, in its order, over surveys of the
configuration's views, and their check against the plain reference.

Each survey reads its box tables (``TabularRectangleSegmentor``, a
DeepForest CSV a view), wraps the cameras (``SegmentorCameraSet``), runs
``aggregate_index_predictions`` at the configuration's
``aggregate_image_scale`` and ``sparse_argmax``, and ends at the (faces x
detections) counts CSR, the views that see each face and each face's
detection.  The crowns, spheres above the surface, are made from the
run's seed; each crown in front of a view gives that view a box, the
bounding box of the crown's outline projected through the lens and
clipped to the frame, and ``missed_share`` of the boxes are dropped.  The
tables of ``survey_pool`` surveys are written in set-up; window survey i
takes pool entry i mod ``survey_pool``, the warm-up one of its own.  The
mesh's tile-list caps are sized in set-up by the port's census over every
pooled view.

The compared numbers, with their limits in ``LIMITS``: ``count_gap`` =
sum |counts - reference| / sum reference counts over the (faces x
detections) matrix, ``seen_gap`` the same over the views that see each
face, and ``label_gap`` the share of the faces the reference labels whose
detection differs.
"""

from __future__ import annotations

import logging
import shutil
import tempfile
from pathlib import Path

import numpy as np
import scipy.sparse
import torch
from torch.profiler import record_function

from benchmark import roofline, scene, system
from benchmark.reference import detect as reference
from benchmark.reference import raster
from geograypher_tpu_torch.cameras.segmentor_set import SegmentorCameraSet
from geograypher_tpu_torch.meshes import sparse
from geograypher_tpu_torch.meshes.mesh import TexturedMesh
from geograypher_tpu_torch.parallel.planner import census_caps
from geograypher_tpu_torch.predictors.segmentors import TabularRectangleSegmentor

LIMITS = {"count_gap": 0.003, "seen_gap": 0.001, "label_gap": 0.02}

CSV_HEADER = ("image_path", "xmin", "ymin", "xmax", "ymax", "label")
TRIPLE_BYTES = 12  # a (face, detection, count) triple out: three 4-byte words


def image_name(view: int) -> str:
    """The image file name of a survey's view ``view``."""
    return f"view_{view:04d}.JPG"


def crown_outline() -> np.ndarray:
    """(26, 3) unit directions: a crown's outline is its centre plus its
    radius times each (the 3 x 3 x 3 lattice's directions)."""
    d = np.stack(np.meshgrid(*[np.array([-1.0, 0.0, 1.0])] * 3, indexing="ij"),
                 -1).reshape(-1, 3)
    d = d[np.abs(d).sum(1) > 0]
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def crowns(verts: np.ndarray, faces: np.ndarray, spec: dict, gen) -> tuple:
    """(centres (n, 3), radii (n,)): ``spec["count"]`` seeded points on the
    surface (a face whose centroid lies in ``region_m``, a uniform point
    of it) at least ``spacing_m`` apart in xy, raised by ``height_m``."""
    tri = np.asarray(verts)[np.asarray(faces)]
    cen = tri.mean(axis=1)
    x0, x1, y0, y1 = spec["region_m"]
    inside = np.nonzero((cen[:, 0] >= x0) & (cen[:, 0] <= x1)
                        & (cen[:, 1] >= y0) & (cen[:, 1] <= y1))[0]
    n = spec["count"]
    pts = np.zeros((0, 3))
    for _ in range(200 * n):
        if len(pts) == n:
            break
        p = gen.dirichlet((1.0, 1.0, 1.0)) @ tri[inside[gen.integers(len(inside))]]
        if len(pts) and np.min(np.hypot(*(pts[:, :2] - p[:2]).T)) < spec["spacing_m"]:
            continue
        pts = np.vstack([pts, p])
    if len(pts) < n:
        raise RuntimeError(f"placed {len(pts)} of {n} crowns")
    pts[:, 2] += gen.uniform(*spec["height_m"], n)
    return pts, gen.uniform(*spec["radius_m"], n)


def view_boxes(centres, radii, c2w, sensor: dict, width: int, height: int):
    """(m, 4) xmin, ymin, xmax, ymax of the crowns in front of one view, in
    crown order: each the bounding box of the crown's projected outline,
    clipped to the frame, where every outline point projects inside the
    lens's domain and the clipped box is not empty."""
    pts = (centres[:, None, :] + radii[:, None, None] * crown_outline()[None]).reshape(-1, 3)
    w2c, f, cx, cy, dist = raster.camera_params(c2w, sensor)
    sx, sy, _, ok = raster.project(torch.as_tensor(pts), w2c, f, cx, cy, dist, width,
                                   height)
    n = len(centres)
    sx, sy = sx.numpy().reshape(n, -1), sy.numpy().reshape(n, -1)
    ok = ok.numpy().reshape(n, -1).all(1)
    box = np.stack([sx.min(1).clip(0, width), sy.min(1).clip(0, height),
                    sx.max(1).clip(0, width), sy.max(1).clip(0, height)], 1)
    return box[ok & (box[:, 2] > box[:, 0]) & (box[:, 3] > box[:, 1])]


def write_tables(folder: Path, survey, centres, radii, sensors: list, width: int,
                 height: int, missed: float, gen) -> int:
    """One DeepForest CSV a view of ``survey`` in ``folder``, boxes in
    crown order, ``missed`` of them dropped at random; returns the rows."""
    folder.mkdir(parents=True, exist_ok=True)
    total = 0
    for k in range(len(survey)):
        box = view_boxes(centres, radii, survey.c2w[k], sensors[survey.sensor[k]], width,
                         height)
        box = box[gen.random(len(box)) >= missed]
        name = image_name(k)
        lines = [",".join(CSV_HEADER)] + [
            f"{name},{x0:.2f},{y0:.2f},{x1:.2f},{y1:.2f},Tree"
            for x0, y0, x1, y1 in box.tolist()]
        (folder / f"{Path(name).stem}.csv").write_text("\n".join(lines) + "\n")
        total += len(box)
    return total


class SparseStats(logging.Handler):
    """The ``sparse_stats`` of ``meshes/sparse.py``'s log records, from
    :meth:`attach` to :meth:`detach` (none from a program that logs none)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        stats = getattr(record, "sparse_stats", None)
        if stats is not None:
            self.records.append(stats)

    def attach(self):
        log = logging.getLogger(sparse.__name__)
        log.setLevel(logging.INFO)
        log.addHandler(self)
        return self

    def detach(self):
        logging.getLogger(sparse.__name__).removeHandler(self)


class DetectSystem:
    """The mesh on the device, as ``project_detections`` builds it, and one
    survey at a time through the functions it calls."""

    def __init__(self, verts, faces, config: dict, traffic: dict, device: torch.device):
        self.mesh = TexturedMesh((verts, faces),
                                 raster_config=system.raster_config(config, traffic),
                                 device=device)
        self.config, self.device = config, device
        self.stats = SparseStats().attach()

    def cameras(self, survey):
        img = self.config["image"]
        return system.camera_set(survey, self.config["sensors"], img["width"],
                                 img["height"],
                                 names=[image_name(k) for k in range(len(survey))])

    def size_caps(self, survey):
        """Tile-list caps that hold every view of ``survey`` at the
        aggregation scale: the port's census, margined as a plan's."""
        self.mesh.raster_config = census_caps(
            self.mesh.view_raster_census(self.cameras(survey),
                                         self.config["aggregate_image_scale"]),
            self.mesh.raster_config)

    def survey(self, survey, tables: Path):
        """(counts CSR (F, detections), views seeing each face (F,), each
        face's detection (F,), NaN where none) of one survey."""
        img = self.config["image"]
        with record_function("bench.survey"):
            with record_function("bench.read_tables"):
                detector = TabularRectangleSegmentor(
                    tables, image_shape=(img["height"], img["width"]))
            cams = SegmentorCameraSet(self.cameras(survey), detector)
            counts, seen = sparse.aggregate_index_predictions(
                self.mesh, cams, n_classes=detector.num_classes,
                aggregate_img_scale=self.config["aggregate_image_scale"])
            return counts, seen, sparse.sparse_argmax(counts)

    def release(self):
        """Drop the program's state, so that the reference finds the memory."""
        self.stats.detach()
        self.mesh = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class Entry:
    """Surveys of the configuration's views (the mix's ``views_per_survey``
    where it gives one) over seeded crowns, their box tables written under
    ``TMPDIR`` in set-up and removed when the run ends."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        img = config["image"]
        self.width, self.height = img["width"], img["height"]
        self.scale = config["aggregate_image_scale"]
        self.sensors = config["sensors"]
        self.views_per_survey = traffic.get("views_per_survey",
                                            config["views_per_survey"])
        self.verts, self.faces = scene.make_mesh(config["mesh"])
        self.system = DetectSystem(self.verts, self.faces, config, traffic, self.device)
        self.stats = self.system.stats
        self.folder = None
        self._last = (None, None)
        self.reseed(seed)

    def reseed(self, seed: int):
        """Make the crowns of ``seed``, the pool's surveys and their tables,
        and size the caps for them; the mesh, a deployment's, stays."""
        self.seed = seed
        if self.folder is not None:
            shutil.rmtree(self.folder, ignore_errors=True)
        self.folder = Path(tempfile.mkdtemp(prefix="bench-detect-"))
        self.centres, self.radii = crowns(self.verts, self.faces, self.config["crowns"],
                                          scene.rng(seed, scene.STREAM_LABELS))
        self.pool = {}
        for k in [-1, *range(self.traffic["survey_pool"])]:
            gen = (scene.rng(seed, scene.STREAM_WARMUP) if k < 0
                   else scene.rng(seed, scene.STREAM_SURVEY, k))
            survey = scene.survey(self.config["views"], self.sensors, self.width,
                                  self.views_per_survey, 1, gen)
            tables = self.folder / f"survey_{k + 1}"
            write_tables(tables, survey, self.centres, self.radii, self.sensors,
                         self.width, self.height, self.traffic["missed_share"], gen)
            self.pool[k] = (survey, tables)
        every = [s for s, _ in self.pool.values()]
        self.system.size_caps(scene.Survey(np.concatenate([s.c2w for s in every]),
                                           np.concatenate([s.sensor for s in every]),
                                           np.concatenate([s.label for s in every])))

    def entry_of(self, index: int):
        """(survey, tables folder) of window survey ``index`` (-1: warm-up)."""
        return self.pool[index if index < 0 else index % self.traffic["survey_pool"]]

    def run(self, index: int) -> scene.Done:
        survey, tables = self.entry_of(index)
        return scene.Done(index, survey, self.system.survey(survey, tables))

    def reference(self, done: scene.Done, dtype=torch.float64):
        """The plain reference's (counts CSR, views seeing each face, each
        face's detection) of a survey; the last float64 one is kept, so
        that the control does not redo it."""
        key = (self.seed, done.index)
        if dtype == torch.float64 and self._last[0] == key:
            return self._last[1]
        survey, tables = self.entry_of(done.index)
        read = reference.read_tables(tables)
        n_det = sum(len(ids) for _, ids in read.values())
        rows, seen = reference.project(
            self.verts, self.faces, survey, self.sensors,
            [image_name(k) for k in range(len(survey))], read, self.width,
            self.height, self.scale, self.device, dtype)
        counts = scipy.sparse.csr_array(
            (rows[:, 2].astype(np.float64), (rows[:, 0], rows[:, 1])),
            shape=(len(self.faces), n_det))
        out = (counts, seen, reference.labels(rows, len(self.faces)))
        if dtype == torch.float64:
            self._last = (key, out)
        return out

    def check(self, done: scene.Done) -> dict:
        """The gaps between the program's survey and the reference's."""
        return gaps(done.result, self.reference(done))

    def control(self, done: scene.Done, dtype) -> dict:
        """The gaps of the reference computed in ``dtype`` in the
        program's place."""
        return gaps(self.reference(done, dtype), self.reference(done))

    def least_seconds(self, surveys: list) -> float:
        """The least time of every view of ``surveys``: per view the mesh
        read once, the painted image at 4 bytes a pixel and the survey's
        triples out at ``TRIPLE_BYTES`` shared over its views, against the
        raster's candidate-pixel operations as ``roofline.py`` counts them
        at the aggregation scale; no term for a dense (faces x detections)
        table, which is the program's choice."""
        v = torch.as_tensor(self.verts, device=self.device)
        fc = torch.as_tensor(self.faces, device=self.device).long()
        w, h = int(self.width * self.scale), int(self.height * self.scale)
        total = 0.0
        for d in surveys:
            n = len(d.survey)
            n_bytes = (len(self.verts) * 12 + len(self.faces) * 12 + w * h * 4
                       + TRIPLE_BYTES * d.result[0].nnz / n)
            for k in range(n):
                sensor = dict(self.sensors[d.survey.sensor[k]])
                sensor["f"] = sensor["f"] * self.scale
                total += roofline.least_seconds(
                    n_bytes, roofline.view_flop(v, fc, d.survey.c2w[k], sensor, w, h))
        return total

    def release(self):
        self.system.release()

    def close(self):
        if self.folder is not None:
            shutil.rmtree(self.folder, ignore_errors=True)


def gaps(program, ref) -> dict:
    """The compared numbers of a survey: ``program`` and ``ref`` each
    (counts CSR, views seeing each face, each face's detection)."""
    counts, seen, labels = program
    ref_counts, ref_seen, ref_labels = ref
    if (counts.shape != ref_counts.shape or np.shape(seen) != ref_seen.shape
            or np.shape(labels) != ref_labels.shape):
        return {name: float("inf") for name in LIMITS}
    diff = scipy.sparse.csr_array(counts, dtype=np.float64) - ref_counts
    labelled = np.isfinite(ref_labels)
    return {
        "count_gap": float(abs(diff).sum()) / max(float(ref_counts.sum()), 1.0),
        "seen_gap": float(np.abs(np.asarray(seen, np.float64) - ref_seen).sum())
        / max(float(ref_seen.sum()), 1.0),
        "label_gap": float((np.asarray(labels)[labelled] != ref_labels[labelled]).mean())
        if labelled.any() else 0.0,
    }
