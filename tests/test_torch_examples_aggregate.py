"""The port's example scripts (``examples_torch/``) against the JAX
package's (``examples/``) on the CPU, aggregation workflows:
``planned_aggregation``, ``aggregate_predictions`` and
``undercanopy_painting``.  Each test runs the port's ``main(tmp,
device="cpu")`` and the JAX script's ``main`` into a second folder.

Per-face equality with the JAX scripts is not the criterion: where a pixel
centre lies on a shared edge, the two packages' float32 triangle setups
may give the pixel to different neighbouring faces (ROADMAP C4; ~1.5% of
the planned survey's pixels).  Tolerances: class totals equal, the same
faces observed, argmax equal on faces both observe, and at most
``MAX_SWAPPED_SHARE`` of the pixel counts moved between faces
(|diff| sum / 2 / total); for fractions the same share of the observed
faces' mass.  The recovered accuracy or agreement equals the JAX value and
meets the JAX tests' bar, and the printed lines are equal but for seconds
and the output folder.

The scripts are loaded by path under unique module names: the JAX
package's ``tests/test_examples.py`` imports them as bare names from
``examples/``, and xdist may put both files in one process."""

import contextlib
import importlib.util
import io
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_rasterize import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
MAX_SWAPPED_SHARE = 0.02
EXAMPLES = ("planned_aggregation", "aggregate_predictions", "undercanopy_painting",
            "render_labels", "colmap_detections", "project_detections",
            "concept_figure", "end_to_end_demo")


def load_example(package, name):
    """``<package>/<name>.py`` as module ``_<package>_<name>``."""
    spec = importlib.util.spec_from_file_location(
        f"_{package}_{name}", ROOT / package / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_example(package, name, out, **kwargs):
    """(return value, printed text with ``out`` and seconds masked)."""
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        value = load_example(package, name).main(out, **kwargs)
    text = printed.getvalue().replace(str(out), "OUT")
    return value, re.sub(r"\d+\.\d+s\b", "<s>", text)


def run_both(name, tmp_path):
    """((folder, value, text) of the port on the CPU, the same of JAX)."""
    port_out, jax_out = tmp_path / "port", tmp_path / "jax"
    port = run_example("examples_torch", name, port_out, device="cpu")
    jax = run_example("examples", name, jax_out)
    return (port_out, *port), (jax_out, *jax)


def swapped_share(a, b):
    """The share of ``a``'s mass that ``b`` holds on other faces."""
    return float(np.abs(a - b).sum() / 2 / a.sum())


def assert_counts_close(port, ref):
    """(F, C) per-face pixel counts of the port against the JAX ones."""
    assert port.shape == ref.shape
    np.testing.assert_array_equal(port.sum(axis=0), ref.sum(axis=0))
    seen = ref.sum(axis=1) > 0
    np.testing.assert_array_equal(port.sum(axis=1) > 0, seen)
    np.testing.assert_array_equal(port[seen].argmax(axis=1), ref[seen].argmax(axis=1))
    assert swapped_share(port, ref) <= MAX_SWAPPED_SHARE


def assert_fractions_close(port, ref):
    """(F, C) per-face class fractions (NaN rows unobserved)."""
    assert port.shape == ref.shape
    seen = np.isfinite(ref).all(axis=1)
    np.testing.assert_array_equal(np.isfinite(port).all(axis=1), seen)
    np.testing.assert_array_equal(port[seen].argmax(axis=1), ref[seen].argmax(axis=1))
    assert swapped_share(port[seen], ref[seen]) <= MAX_SWAPPED_SHARE


def test_planned_aggregation_matches_jax(tmp_path):
    (port_out, value, text), (jax_out, jax_value, jax_text) = run_both(
        "planned_aggregation", tmp_path)
    assert value is None and jax_value is None
    counts = np.load(port_out / "planned_counts.npy")
    ref = np.load(jax_out / "planned_counts.npy")
    assert_counts_close(counts, ref)
    assert 0 < swapped_share(counts, ref)  # the float32 setups' swaps
    agree = float(re.search(r"agreement on observed faces: (\S+)", text).group(1))
    assert agree >= 0.95
    assert text == jax_text


def test_aggregate_predictions_matches_jax(tmp_path):
    (port_out, accuracy, text), (jax_out, jax_accuracy, jax_text) = run_both(
        "aggregate_predictions", tmp_path)
    assert accuracy == jax_accuracy == 1.0
    assert_fractions_close(np.load(port_out / "aggregated_face_labels.npy"),
                           np.load(jax_out / "aggregated_face_labels.npy"))
    assert text == jax_text
    # the confusion matrix as a viridis image: a 32 px square a class, the
    # diagonal at the table's top colour, the rest at its bottom one
    from geograypher_tpu_torch.utils.colormaps import VIRIDIS
    from geograypher_tpu_torch.utils.io import read_image_or_numpy

    image = read_image_or_numpy(port_out / "confusion_matrix.png")
    assert image.shape == (3 * 32, 3 * 32, 3) and image.dtype == np.uint8
    top, bottom = (np.round(VIRIDIS[i] * 255) for i in (-1, 0))
    for r in range(3):
        for c in range(3):
            cell = image[32 * r:32 * r + 32, 32 * c:32 * c + 32]
            assert (cell == (top if r == c else bottom)).all()


def test_undercanopy_painting_matches_jax(tmp_path):
    (port_out, accuracy, text), (jax_out, jax_accuracy, jax_text) = run_both(
        "undercanopy_painting", tmp_path)
    assert accuracy == jax_accuracy == 1.0  # tests/test_rig_e2e.py's bar
    assert_fractions_close(np.load(port_out / "aggregated_face_labels.npy"),
                           np.load(jax_out / "aggregated_face_labels.npy"))
    assert text == jax_text


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_needs_a_card_by_default(tmp_path, name, monkeypatch):
    """``main`` with no device runs on the card: without one it raises
    before it writes anything, never falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        load_example("examples_torch", name).main(tmp_path / "out")
    assert not (tmp_path / "out").exists()
