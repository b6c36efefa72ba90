"""The port's example scripts against the JAX package's on the CPU,
rendering workflows: ``render_labels`` and ``concept_figure`` (see
``tests/test_torch_examples_aggregate.py`` for how the scripts are run),
and the concept figure's ``hsv_to_rgb`` against matplotlib's.

Tolerances: each mask, composite, realistic view and label image at least
``MIN_MASK_EQUAL`` equal to the JAX script's file (knife-edge pixels of
the float32 setups, ROADMAP C4); the recovered agreement equal to the JAX
value; the printed lines equal (the concept figure's count of observed
object faces within ``MAX_SWAPPED_SHARE``); ``hsv_to_rgb`` to 1e-15.  The concept
figure's panels are held to the images they are composed of: the port
draws them in numpy, the JAX script with matplotlib."""

import re

import matplotlib.colors
import numpy as np

from tests.test_torch_examples_aggregate import (
    MAX_SWAPPED_SHARE,
    load_example,
    one_torch_thread,  # noqa: F401
    run_both,
)

MIN_MASK_EQUAL = 0.99


def assert_images_close(port_dir, jax_dir, pattern="*.png"):
    """Each file of ``jax_dir`` in ``port_dir`` too, decoded, of one shape
    and at least ``MIN_MASK_EQUAL`` of its pixels equal; returns the
    count."""
    from geograypher_tpu_torch.utils.io import read_image_or_numpy

    names = sorted(p.relative_to(jax_dir) for p in jax_dir.rglob(pattern))
    assert names == sorted(p.relative_to(port_dir) for p in port_dir.rglob(pattern))
    for name in names:
        a = read_image_or_numpy(port_dir / name)
        b = read_image_or_numpy(jax_dir / name)
        assert a.shape == b.shape, name
        same = (a == b).all(axis=-1) if a.ndim == 3 else a == b
        assert same.mean() >= MIN_MASK_EQUAL, (name, same.mean())
    return len(names)


def test_render_labels_matches_jax(tmp_path):
    (port_out, n_rendered, text), (jax_out, jax_rendered, jax_text) = run_both(
        "render_labels", tmp_path)
    assert n_rendered == jax_rendered >= 4  # tests/test_examples.py's bar
    assert assert_images_close(port_out / "rendered_labels",
                               jax_out / "rendered_labels") == n_rendered
    assert assert_images_close(port_out / "label_vis", jax_out / "label_vis") == 4
    assert text == jax_text


def test_concept_figure_matches_jax(tmp_path):
    from geograypher_tpu_torch.utils.io import read_image_or_numpy

    (port_out, agreement, text), (jax_out, jax_agreement, jax_text) = run_both(
        "concept_figure", tmp_path)
    assert agreement == jax_agreement > 0.9  # tests/test_examples.py's bar
    for folder in ("realistic_images", "labeled_images"):
        assert assert_images_close(port_out / folder, jax_out / folder) == 6
    # the printed lines equal, but the count of observed object faces: a
    # face seen through one knife-edge pixel in one package only
    observed = re.compile(r"on (\d+) observed object faces")
    lines, jax_lines = text.splitlines(), jax_text.splitlines()
    assert len(lines) == len(jax_lines)
    for line, jax_line in zip(lines, jax_lines):
        assert observed.sub("", line) == observed.sub("", jax_line)
        if observed.search(line):
            n = int(observed.search(line).group(1))
            n_jax = int(observed.search(jax_line).group(1))
            assert abs(n - n_jax) <= MAX_SWAPPED_SHARE * n_jax
    module = load_example("examples_torch", "concept_figure")
    # the views panel: realistic views 0-2 over their label images in tab10
    grid = read_image_or_numpy(port_out / "figures" / "concept_views.png")
    side, gap = module.SENSOR, module.PANEL_GAP
    assert grid.shape == (2 * side + 3 * gap, 3 * side + 4 * gap, 3)
    for k in range(3):
        x = gap + k * (side + gap)
        rgb = read_image_or_numpy(port_out / "realistic_images" / f"view_{k:02d}.png")
        lab = read_image_or_numpy(port_out / "labeled_images" / f"view_{k:02d}.png")
        np.testing.assert_array_equal(grid[gap:gap + side, x:x + side], rgb)
        bottom = grid[2 * gap + side:2 * gap + 2 * side, x:x + side]
        np.testing.assert_array_equal(bottom, module.label_panel(lab))
        assert (bottom[lab == 255] == 255).all()
        tab10 = np.round(matplotlib.colormaps["tab10"](lab[lab < 255])[:, :3] * 255)
        np.testing.assert_array_equal(bottom[lab < 255], tab10)
    # the footprint map: every instance's footprint coloured, white around
    footprints = read_image_or_numpy(port_out / "figures" / "object_map.png")
    assert footprints.shape == (module.MAP_PX, module.MAP_PX, 3)
    assert (footprints[0] == 255).all() and (footprints[:, 0] == 255).all()
    colours = {tuple(c) for c in footprints.reshape(-1, 3)} - {(255, 255, 255)}
    assert len(colours) >= len(module.IDS_TO_LABELS)


def test_hsv_to_rgb_matches_matplotlib():
    module = load_example("examples_torch", "concept_figure")
    h, s, v = np.meshgrid(np.linspace(0.0, 1.0, 121), np.linspace(0.0, 1.0, 11),
                          np.linspace(0.0, 1.0, 11), indexing="ij")
    hsv = np.stack([h, s, v], axis=-1)
    np.testing.assert_allclose(module.hsv_to_rgb(hsv), matplotlib.colors.hsv_to_rgb(hsv),
                               rtol=0, atol=1e-15)
    for hue in np.linspace(0.0, 1.0, 97):
        np.testing.assert_allclose(module.hsv_to_rgb([hue, 0.8, 0.9]),
                                   matplotlib.colors.hsv_to_rgb([hue, 0.8, 0.9]),
                                   rtol=0, atol=1e-15)
