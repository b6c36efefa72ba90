"""The port and chip_smoke.py import no JAX and nothing of the JAX
package: the machine with the card has no jax (nor cv2, PIL or pandas),
and the port keeps its own copies of the host helpers it needs.  Checked
in subprocesses, because tests/conftest.py imports jax into this one."""

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

REFUSED = ("jax", "jaxlib", "geograypher_tpu", "cv2", "PIL", "pandas")
refuse(*REFUSED)
import geograypher_tpu_torch
names = ["chip_smoke"] + [
    m.name for m in pkgutil.walk_packages(
        geograypher_tpu_torch.__path__, "geograypher_tpu_torch.")
]
for name in names:
    importlib.import_module(name)
assert not loaded(*REFUSED), loaded(*REFUSED)
print(len(names))
"""

# chip_smoke.py's main path at a tiny size on CPU tensors, with the whole
# JAX package refused: the scene, the sorted mesh, a segmentor camera set
# and the streaming aggregation, with level S off and on
CHIP_PATH = REFUSE + r"""
REFUSED = ("jax", "jaxlib", "geograypher_tpu", "cv2", "PIL", "pandas")
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
assert cs.subtile.launches == 0  # CPU tensors take the plain versions
assert not loaded(*REFUSED), loaded(*REFUSED)
print("ok")
"""


def run(code):
    # one intra-op thread: the tiny tensors gain nothing from more, and
    # parallel test workers would oversubscribe the cores
    return subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"},
    )


def test_no_port_file_imports_the_jax_package():
    """A source scan: no import of ``geograypher_tpu`` (or jax) in any
    file of the port or in chip_smoke.py, at module level or lazily."""
    pattern = re.compile(r"^\s*(from|import)\s+(geograypher_tpu|jax)([.\s]|$)")
    files = sorted((ROOT / "geograypher_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) >= 25
    bad = [f"{f.relative_to(ROOT)}:{i}: {line.strip()}"
           for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if pattern.match(line)]
    assert not bad, bad


def test_port_and_chip_smoke_import_no_jax():
    out = run(IMPORT_ALL)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15  # every module was imported


def test_chip_smoke_path_needs_nothing_of_the_jax_package():
    out = run(CHIP_PATH)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_refuses_to_run_without_cuda():
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "CUDA" in out.stderr
