"""The port and chip_smoke.py import no JAX and nothing of the JAX
package: the machine with the card has no jax (nor cv2, PIL, pandas or
networkx, and is not said to have imageio or sklearn), and the port keeps
its own copies of the host helpers it needs.  Checked in subprocesses,
because tests/conftest.py imports jax into this one."""

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

REFUSE = r"""
import sys

class Refuse:
    def __init__(self, roots):
        self.roots = roots

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in self.roots:
            raise ImportError(f"{name} is refused")
        return None

def refuse(*roots):
    sys.meta_path.insert(0, Refuse(roots))

def loaded(*roots):
    return sorted(k for k in sys.modules if k.split(".")[0] in roots)
"""

IMPORT_ALL = REFUSE + r"""
import importlib, pkgutil

REFUSED = ("jax", "jaxlib", "geograypher_tpu", "cv2", "PIL", "pandas",
           "sklearn", "networkx", "rasterio", "osgeo", "matplotlib")
refuse(*REFUSED)
import geograypher_tpu_torch
names = ["chip_smoke"] + [
    m.name for m in pkgutil.walk_packages(
        geograypher_tpu_torch.__path__, "geograypher_tpu_torch.")
]
assert "geograypher_tpu_torch.ops.onehot" in names, names
assert "geograypher_tpu_torch.entrypoints.render_labels" in names, names
assert "geograypher_tpu_torch.utils.vector" in names, names
assert "geograypher_tpu_torch.parallel.planner" in names, names
assert "geograypher_tpu_torch.ops.face_sums" in names, names
for name in ("parallel.pipeline", "parallel.sharding", "meshes.chunked",
             "utils.kmeans", "utils.numeric", "utils.louvain", "utils.polyfill",
             "utils.exact_geometry", "ops.raycast", "ops.triangulate",
             "meshes.sparse", "entrypoints.project_detections",
             "entrypoints.multiview_detections", "utils.tiff", "utils.raster",
             "utils.contours", "utils.boolean_ops", "utils.geospatial",
             "entrypoints.render_height_masks", "entrypoints.label_polygons",
             "utils.profiling", "utils.indexing", "utils.prediction_metrics",
             "predictors.ortho", "entrypoints.annotation_image_selection",
             "entrypoints.chip_ortho", "entrypoints.assemble_ortho_predictions",
             "cameras.colmap", "cameras.rig", "utils.image", "utils.colormaps",
             "utils.visualization", "utils.html_viewer", "entrypoints.visualize"):
    assert "geograypher_tpu_torch." + name in names, names
for name in names:
    importlib.import_module(name)
assert not loaded(*REFUSED), loaded(*REFUSED)
print(len(names))
"""

# chip_smoke.py's main path at a tiny size on CPU tensors, with the whole
# JAX package refused: the scene, the sorted mesh, a segmentor camera set,
# the one-hot probes (accepted images against the numpy scan, refused
# images down the means path), the streaming aggregation with level S off
# and on, phases 6 and 6m (the planner and the means path), and phases 7
# and 7c (the survey pipeline, chunked aggregation, view sharding)
CHIP_PATH = REFUSE + r"""
REFUSED = ("jax", "jaxlib", "geograypher_tpu", "cv2", "PIL", "pandas",
           "imageio", "sklearn", "networkx")
refuse(*REFUSED)
import numpy as np
import chip_smoke as cs

verts, faces = cs.make_grid_mesh(n=9, size=4.0,
                                 z_fn=lambda x, y: 0.1 * np.sin(3 * x))
mesh = cs.TexturedMesh((verts, faces), raster_config=cs.RasterConfig(),
                       device="cpu")
mesh.spatial_sort_faces()
w, h = 64, 48
c2ws = [cs.nadir_camera(4.0, 40.0, w),
        cs.oblique_camera(4.0, 40.0, w, pitch_deg=25.0)]
sensors = {0: {"f": 40.0, "image_width": w, "image_height": h},
           1: {"f": 40.0, "image_width": w, "image_height": h,
               "distortion_params": {"k1": 0.02}}}
cams = cs.CameraSet(c2ws, sensors, sensor_IDs=[0, 1])
labels = np.random.default_rng(0).integers(0, 3, (2, h, w), dtype=np.int8)
seg = cs.SegmentorCameraSet(cams, cs.LabelSegmentor(labels, 3))
assert seg.get_image_by_index(1).dtype == np.float32
probes = list(cs._onehot_probe_images(seg.get_image_by_index(0)))
assert [accept for _, _, accept in probes] == [True] * 3 + [False] * 3
for name, image, accept in probes:
    cs._check_onehot(name, image, accept, "cpu")
    if not accept:
        cs._check_refused_takes_means(name, mesh, cams, image)
cs.onehot.launches = 0
avg, info = mesh.aggregate_projected_images(seg)
seen = info["projection_counts"] > 0
assert avg.shape == (len(faces), 3) and seen.mean() > 0.5
assert np.allclose(avg[seen].sum(axis=1), 1.0, atol=1e-5)
assert np.isnan(avg[~seen]).all()
s_cfg = cs.RasterConfig(bin_block=8, l0_window=(5, 2), subtile=(8, 16))
mesh_s = cs.TexturedMesh((verts, faces), raster_config=s_cfg, device="cpu")
mesh_s.spatial_sort_faces()
cs.subtile.launches = 0
avg_s, info_s = mesh_s.aggregate_projected_images(seg)
seen_s = info_s["projection_counts"] > 0
assert (seen_s == seen).mean() > 0.95
assert np.allclose(avg_s[seen_s].sum(axis=1), 1.0, atol=1e-5)
assert np.isnan(avg_s[~seen_s]).all()
# CPU tensors take the plain versions
assert cs.subtile.launches == 0 and cs.onehot.launches == 0
# phase 6 (the planner, its route, a forced retry, one bucket against
# four) and phase 6m (the means path twice, face_sums against plain)
launches, fields = cs._planned_phase(mesh, cams, seg, labels, 3,
                                     forced_caps=(1, 1, 1, 1))
assert fields["forced_resizes"] >= 1 and fields["buckets"]
assert not any(launches.values()), launches
launches, row = cs._means_phase(mesh, cams, h, w, 3, timing=False)
assert row["max_abs_err"] == 0.0 and row["faces_hit"] > 0
assert not any(launches.values()), launches
# phase 7 (the survey pipeline: a provider, the one-hot default, a forced
# retry, two shards) and 7c (chunked aggregation, view sharding)
devices = ["cpu", "cpu"]
launches, fields = cs._pipeline_phase(mesh, cams, labels, 3, devices,
                                      forced_caps=(1, 1, 1, 1), timing=False)
assert fields["forced_retried_views"] == 2 and fields["retried_views"] == 0
assert not any(launches.values()), launches
named = cs.SegmentorCameraSet(
    cs.CameraSet(c2ws, sensors, image_filenames=["a.png", "b.png"],
                 sensor_IDs=[0, 1]),
    cs.LabelSegmentor(labels, 3, ["a.png", "b.png"]))
launches, fields = cs._chunked_aggregate_check(mesh, named, 3)
assert fields["clusters"] == [1, 1] and not any(launches.values())
launches, fields = cs._sharded_check(mesh, cams, mesh.raster_config, devices, 3)
assert fields["sharded_seen_faces"] > 0 and not any(launches.values())
assert fields["sharded"]["one"]["bit_equal"]
assert not loaded(*REFUSED), loaded(*REFUSED)
print("ok")
"""


# chip_smoke.py's phase 5 at a tiny size on CPU tensors, with the same
# modules refused: the survey written to disk (PLY, Metashape XML with
# three sensors, GeoJSON), ``render_labels`` with every check of the masks
# (PNG through the port's own codec, the plain re-runs, the cache), the
# round trip through ``aggregate_images``, and phase 7c's chunked render
RENDER_PATH = REFUSE + r"""
REFUSED = ("jax", "jaxlib", "geograypher_tpu", "cv2", "PIL", "pandas",
           "imageio", "sklearn", "networkx")
refuse(*REFUSED)
import tempfile
import numpy as np
import chip_smoke as cs

verts, faces = cs.make_grid_mesh(n=21, size=4.0,
                                 z_fn=lambda x, y: 0.1 * np.sin(3 * x))
w, h = 96, 64
c2ws = [cs.nadir_camera(4.0, 40.0, w),
        cs.oblique_camera(4.0, 45.0, w, pitch_deg=25.0),
        cs.nadir_camera(4.0, 45.0, w)]
c2ws[0][:3, 3] += (0.013, -0.021, 0.0)
sensors = {0: {"f": 40.0, "image_width": w, "image_height": h},
           1: {"f": 45.0, "image_width": w, "image_height": h},
           2: {"f": 45.0, "cx": 0.5, "cy": -0.5, "image_width": w,
               "image_height": h,
               "distortion_params": {"k1": 0.02, "k2": -0.01, "p1": 1e-3}}}
cfg = cs.RasterConfig(caps=(512, 128, 64, 64))
with tempfile.TemporaryDirectory() as folder:
    survey = cs._write_survey(folder, verts, faces, c2ws, sensors, [0, 1, 2], w, h)
    mesh, cams, launches, fields = cs._render_checked(survey, cfg, device="cpu")
    assert fields["plain_rerun_views"] == [0, 2] and fields["overflow"] == 0
    assert mesh.n_faces == len(faces) and len(cams) == 3
    assert sorted(mesh.IDs_to_labels.values()) == list(cs.SPECIES)
    assert 0.3 < fields["labelled_vertex_share"] < 0.7
    trip = cs._round_trip(survey, mesh, cfg, device="cpu", min_agree=0.95)
    assert trip["observed_and_labelled"] > 0.3 * len(faces)
    # phase 7c's chunked render against phase 5's files
    chunk_launches, chunk = cs._chunked_render_check(survey, cfg, device="cpu")
    assert chunk["render_files"] == 3 and not any(chunk_launches.values())
# CPU tensors take the plain versions
assert not any(launches.values()), launches
assert not loaded(*REFUSED), loaded(*REFUSED)
print("ok")
"""


# chip_smoke.py's phase 8 at a tiny size on CPU tensors, with the same
# modules refused: the survey and the objects' detections written to disk,
# ``project_detections`` against its plain run with the kernels' checks on
# view 0, ``multiview_detections`` recovering every object, twice and from
# its cache files
DETECTION_PATH = REFUSE + r"""
REFUSED = ("jax", "jaxlib", "geograypher_tpu", "cv2", "PIL", "pandas",
           "imageio", "sklearn", "networkx")
refuse(*REFUSED)
import tempfile
import numpy as np
import chip_smoke as cs

verts, faces = cs.make_grid_mesh(n=21, size=4.0,
                                 z_fn=lambda x, y: 0.1 * np.sin(3 * x))
w, h = 96, 64
c2ws = []
for k in range(6):
    if k % 2 == 0:
        c = cs.nadir_camera(4.0, 50.0, w)
        c[:3, 3] += (0.05 * k - 0.1, 0.03 * k, 0.0)
    else:
        c = cs.oblique_camera(4.0, 65.0, w, pitch_deg=20.0 + 3 * k,
                              azimuth_deg=60.0 * k)
    c2ws.append(c)
sensors = {0: {"f": 50.0, "image_width": w, "image_height": h},
           1: {"f": 65.0, "image_width": w, "image_height": h},
           3: {"f": 65.0, "image_width": w, "image_height": h,
               "distortion_params": {"k1": 0.02}}}
with tempfile.TemporaryDirectory() as folder:
    launches, row = cs._detection_phase(
        folder, verts, faces, c2ws, sensors, [0, 1, 0, 1, 0, 3],
        cs.RasterConfig(caps=(512, 128, 64, 64)), w=w, h=h, n_objects=12,
        box=6.0, device="cpu", timing=False)
# CPU tensors take the plain versions
assert not any(launches.values()), launches
assert row["classes"] == 12 and row["max_abs_err"] == 0
assert not loaded(*REFUSED), loaded(*REFUSED)
print("ok")
"""

# chip_smoke.py's phase 9 at a tiny size on CPU tensors, with the same
# modules refused: a DTM GeoTIFF written and read by the port's own codec,
# heights above ground, ``render_height_masks``, ``aggregate_images`` with
# the DTM on the planned route, the orthographic raster untiled and tiled,
# the raster vector export and ``label_polygons`` in three modes; with
# ``PHASE10`` set, phase 10 after it on the same folder
PHASE9_PATH = REFUSE + r"""
REFUSED = ("jax", "jaxlib", "geograypher_tpu", "cv2", "PIL", "pandas",
           "imageio", "sklearn", "networkx", "rasterio", "osgeo", "matplotlib")
refuse(*REFUSED)
import tempfile
from pathlib import Path
import numpy as np
import torch
import chip_smoke as cs
from geograypher_tpu_torch.meshes.mesh import TexturedMesh

TexturedMesh._PLANNED_MIN_PIXELS = 1  # the planned route at this size
cs.DTM_SIZE, cs.DTM_TILE = 256, (64, 64)
cs.ORTHO_RES_M, cs.ORTHO_TILED_MAX_PIXELS, cs.ORTHO_BIG_RES_M = 0.02, 80, 0.01
verts, faces = cs.make_grid_mesh(n=41, size=4.0, z_fn=lambda x, y: cs._surface(x, y))
w, h = 96, 64
c2ws = []
for k in range(6):
    if k % 2 == 0:
        c = cs.nadir_camera(4.0, 50.0, w)
        c[:3, 3] += (0.05 * k - 0.1, 0.03 * k, 0.0)
    else:
        c = cs.oblique_camera(4.0, 65.0, w, pitch_deg=20.0 + 3 * k,
                              azimuth_deg=60.0 * k)
    c2ws.append(c)
sensors = {0: {"f": 50.0, "image_width": w, "image_height": h},
           1: {"f": 65.0, "image_width": w, "image_height": h},
           3: {"f": 65.0, "image_width": w, "image_height": h,
               "distortion_params": {"k1": 0.02}}}
with tempfile.TemporaryDirectory() as folder:
    survey = cs._write_survey(Path(folder) / "detections", verts, faces, c2ws, sensors,
                              [0, 1, 0, 1, 0, 3], w, h, phase="8a")
    launches, row, row_b, big = cs._phase9(folder, survey, verts,
                                           cs.RasterConfig(caps=(2048, 512, 256, 256)),
                                           torch.device("cpu"))
    assert big["p2f"].shape == (409, 409) and big["epsg"] == 32611
    if PHASE10:
        # phase 10: image selection over 12 views of the suite's pattern at
        # scale 0.5 (every 5th view held against the plain run) and the 6
        # survey views at 1.0; the ortho chipped in 128 px chips at a 64 px
        # stride, predictions assembled, scored
        cs.SELECTION_PLAIN_EVERY = 5
        cs.CHIP_SIZE, cs.CHIP_STRIDE, cs.CHIP_TILE = 128, 64, (64, 64)
        sel_sensors = {k: sensors[v] for k, v in ((0, 0), (1, 1), (2, 0), (3, 3))}
        more = cs._selection_phase(folder, survey, sel_sensors, "cpu", n_views=12,
                                   scale=0.5, width=w, height=h)
        assert not any(more.values()), more
        more = cs._ortho_predict_phase(folder, survey, big, "cpu")
        assert not any(more.values()), more
# CPU tensors take the plain versions
assert not any(launches.values()), launches
assert row["max_abs_err"] == 0 and row["shape"] == [205, 205]
assert not loaded(*REFUSED), loaded(*REFUSED)
print("ok")
"""


# chip_smoke.py's phase 11 at a tiny size on CPU tensors, with the same
# modules refused: 10a's census-cap selection (for its picks), the COLMAP
# export and its aggregation against the matrices' (11a), the under-canopy
# rig survey and its aggregation (11b), composites and ``visualize`` with
# the HTML export (11c), ``rasterize_batch`` and the selection at its
# default caps (11d)
PHASE11_PATH = REFUSE + r"""
REFUSED = ("jax", "jaxlib", "geograypher_tpu", "cv2", "PIL", "pandas",
           "imageio", "sklearn", "networkx", "rasterio", "osgeo", "matplotlib")
refuse(*REFUSED)
import tempfile
from pathlib import Path
import numpy as np
import chip_smoke as cs
from geograypher_tpu_torch.meshes.mesh import TexturedMesh

TexturedMesh._PLANNED_MIN_PIXELS = 1  # the planned route at this size
w, h = 96, 64
verts, faces = cs.make_grid_mesh(n=41, size=4.0, z_fn=lambda x, y: cs._surface(x, y))
dist = {"k1": 0.02, "k2": -0.01, "p1": 1e-3}
sensors = {k: {"f": (50.0, 65.0)[k % 2], "cx": 0.0, "cy": 0.0, "image_width": w,
               "image_height": h, **({"distortion_params": dist} if k > 1 else {})}
           for k in range(4)}
cfg = cs.RasterConfig(caps=(512, 128, 64, 64))
mesh = TexturedMesh((verts, faces), raster_config=cfg, device="cpu")
mesh.spatial_sort_faces()
c2ws, ids = cs._suite_cameras(n_views=4), cs._suite_sensor_ids(4)
cams = cs.CameraSet(c2ws, sensors, sensor_IDs=ids)
launches = []
with tempfile.TemporaryDirectory() as folder:
    survey = cs._write_survey(folder, verts, faces, c2ws, sensors, ids, w, h)
    selection = Path(folder) / "selection_cameras.xml"
    cs._write_cameras(selection, cs._suite_cameras(n_views=6), sensors,
                      cs._suite_sensor_ids(6), w, h)
    picks = {}
    launches.append(cs._selection_run(survey["mesh_file"], selection, 0.5, "cpu",
                                      plain_every=3, picks=picks))
    launches.append(cs._colmap_phase(folder, mesh, sensors, "cpu", n_views=4, width=w,
                                     height=h, n_big=20, n_points=50))
    launches.append(cs._rig_phase(folder, "cpu", n_stations=2, sensor=32, pano=(64, 128)))
    launches.append(cs._composite_phase(folder, survey, c2ws, sensors, ids, cfg.caps, "cpu",
                                        n_views=2, width=w, height=h, res_m=0.02))
    launches.append(cs._batch_phase(mesh, cams, cfg, cfg.caps, dict(
        mesh_file=survey["mesh_file"], cameras_file=selection), picks["10a"], "cpu",
        scale=0.5))
# CPU tensors take the plain versions
assert not any(any(row.values()) for row in launches), launches
assert not loaded(*REFUSED), loaded(*REFUSED)
print("ok")
"""


# examples_torch/colmap_detections.py's main on the CPU with those modules
# refused, imageio too; then chip_smoke.py's phase 12 on the CPU for it and
# project_detections (both runs on the CPU: nothing launches)
EXAMPLE_PATH = REFUSE + r"""
REFUSED = ("jax", "jaxlib", "geograypher_tpu", "cv2", "PIL", "pandas",
           "imageio", "sklearn", "networkx", "rasterio", "osgeo", "matplotlib")
refuse(*REFUSED)
import tempfile
import numpy as np
import chip_smoke as cs
from examples_torch import colmap_detections

with tempfile.TemporaryDirectory() as folder:
    located, objects = colmap_detections.main(folder, device="cpu")
    launches = cs._examples_phase(folder + "/12", device="cpu",
                                  names=("colmap_detections", "project_detections"))
assert len(located) == len(objects) == colmap_detections.N_OBJECTS
gaps = np.linalg.norm(located[:, None] - objects[None], axis=-1).min(axis=1)
assert gaps.max() < 0.1, gaps
assert not any(launches.values()), launches
assert not loaded(*REFUSED), loaded(*REFUSED)
print("ok")
"""
# the roots no script of examples_torch/ may import: the IMPORT_ALL list's,
# and imageio
EXAMPLE_REFUSED = ("jax", "jaxlib", "geograypher_tpu", "cv2", "PIL", "pandas",
                   "sklearn", "networkx", "rasterio", "osgeo", "matplotlib", "imageio")


def run(code):
    # one intra-op thread: the tiny tensors gain nothing from more, and
    # parallel test workers would oversubscribe the cores
    return subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"},
    )


def test_no_port_file_imports_the_jax_package():
    """A source scan: no import of ``geograypher_tpu`` (or jax, cv2, PIL,
    pandas, sklearn, networkx, rasterio, GDAL) in any file of the port or
    in chip_smoke.py, at module level or lazily; ``imageio`` only in the
    guarded fallback of ``utils/io.py``."""
    pattern = re.compile(r"^\s*(from|import)\s+"
                         r"(geograypher_tpu|jax|cv2|PIL|pandas|sklearn|networkx|"
                         r"rasterio|osgeo)([.\s]|$)")
    files = sorted((ROOT / "geograypher_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) >= 25
    bad = [f"{f.relative_to(ROOT)}:{i}: {line.strip()}"
           for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if pattern.match(line)]
    assert not bad, bad
    uses_imageio = [str(f.relative_to(ROOT)) for f in files
                    if re.search(r"^\s*(from|import)\s+imageio", f.read_text(), re.M)]
    assert uses_imageio == ["geograypher_tpu_torch/utils/io.py"]
    io_source = (ROOT / "geograypher_tpu_torch/utils/io.py").read_text()
    assert re.search(r"try:\n\s+import imageio.v3 as iio\n\s+except ImportError:",
                     io_source)


def test_port_and_chip_smoke_import_no_jax():
    out = run(IMPORT_ALL)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 59  # every module was imported


def test_chip_smoke_path_needs_nothing_of_the_jax_package():
    out = run(CHIP_PATH)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_chip_smoke_render_path_needs_nothing_of_the_jax_package():
    out = run(RENDER_PATH)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_chip_smoke_detection_path_needs_nothing_of_the_jax_package():
    out = run(DETECTION_PATH)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_chip_smoke_dtm_ortho_polygon_path_needs_nothing_of_the_jax_package():
    out = run("PHASE10 = False\n" + PHASE9_PATH)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_chip_smoke_selection_and_ortho_predict_path_needs_nothing_of_the_jax_package():
    out = run("PHASE10 = True\n" + PHASE9_PATH)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "ok"
    phases = [json.loads(ln)["phase"] for ln in lines if ln.startswith("{")]
    assert {"10a", "10a_full", "10b"} <= set(phases), phases


def test_chip_smoke_phase11_path_needs_nothing_of_the_jax_package():
    out = run(PHASE11_PATH)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "ok"
    phases = [json.loads(ln)["phase"] for ln in lines if ln.startswith("{")]
    assert {"11a", "11b", "11c", "11d"} <= set(phases), phases


def test_chip_smoke_refuses_to_run_without_cuda():
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "CUDA" in out.stderr


def _import_roots(path):
    """(root module, line, at module level) of every import in ``path``,
    function-level imports included."""
    tree = ast.parse(path.read_text())
    top = set(map(id, tree.body))
    roots = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if not node.level else []
        else:
            continue
        roots += [(n.split(".")[0], node.lineno, id(node) in top) for n in names]
    return roots


def test_examples_import_only_the_port_torch_numpy_scipy_and_the_standard_library():
    """An AST scan of every import of every ``examples_torch/*.py``, the
    imports inside functions too (the scripts import lazily in ``main``)."""
    files = sorted((ROOT / "examples_torch").glob("*.py"))
    names = {f.stem for f in files} - {"__init__"}
    assert names == {f.stem for f in (ROOT / "examples").glob("*.py")}
    allowed = {"geograypher_tpu_torch", "torch", "numpy", "scipy"} | set(
        sys.stdlib_module_names)
    lazy = 0
    for f in files:
        roots = _import_roots(f)
        refused = [r for r in roots if r[0] in EXAMPLE_REFUSED]
        assert not refused, (f.name, refused)
        other = [r for r in roots if r[0] not in allowed]
        assert not other, (f.name, other)
        lazy += sum(not at_top for _, _, at_top in roots)
    assert lazy >= 8  # the walk reached the imports inside functions


def test_example_runs_with_the_jax_package_refused():
    out = run(EXAMPLE_PATH)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "ok"
    rows = [json.loads(ln) for ln in lines if ln.startswith("{")]
    assert [r.get("example") for r in rows] == ["colmap_detections",
                                                "project_detections", None]
    assert all(r["equal_cpu"] for r in rows[:2])
