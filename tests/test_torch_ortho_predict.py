"""Ortho chipping and the assembly of chip predictions
(``predictors/ortho.py``, ``entrypoints/chip_ortho.py``,
``entrypoints/assemble_ortho_predictions.py``) of the PyTorch port
against the JAX package on the CPU.

Windows and chip names are the JAX package's; ``write_chips`` writes the
same files (read with PIL: the same pixels, cv2's BGR order included,
the same label mapping and the same skips); ``assemble_tiled_predictions``
on CPU tensors and the plain numpy version write rasters bit-equal to the
JAX package's, on ``tests/test_predictors.py``'s scene and on a seeded
scene of 4-way overlapping chips with saturating counts and nodata."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from geograypher_tpu.predictors import ortho as jortho
from geograypher_tpu.utils.raster import Raster as JaxRaster
from geograypher_tpu.utils.raster import read_geotiff as jax_read_geotiff
from geograypher_tpu.utils.raster import write_geotiff as jax_write_geotiff
from geograypher_tpu.utils.vector import Polygon as JaxPolygon
from geograypher_tpu.utils.vector import VectorData as JaxVectorData
from geograypher_tpu_torch.entrypoints.assemble_ortho_predictions import (
    assemble_ortho_predictions,
)
from geograypher_tpu_torch.predictors import ortho
from geograypher_tpu_torch.utils.io import write_image
from geograypher_tpu_torch.utils.raster import read_geotiff
from tests.test_torch_rasterize import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TRANSFORM = (1.0, 0, 500000.0, 0, -1.0, 4000000.0)


@pytest.mark.parametrize("shape,size,stride", [((100, 120), 48, 32), ((64, 64), 64, 64),
                                               ((7, 300), 16, 5), ((33, 1), 8, 8)])
def test_windows_and_names_match_jax(shape, size, stride):
    want = list(jortho.create_windows(shape, size, stride))
    assert list(ortho.create_windows(shape, size, stride)) == want
    names = [ortho.get_str_from_window(w, ".png") for w in want]
    assert names == [jortho.get_str_from_window(w, ".png") for w in want]
    paths = [Path("x") / n for n in names]
    assert ortho.parse_windows_from_files(paths) == jortho.parse_windows_from_files(paths)
    assert ortho.parse_windows_from_files(paths) == want


def _labels(path):
    JaxVectorData(
        [JaxPolygon(np.array([[500010, 3999990], [500050, 3999990], [500050, 3999950],
                              [500010, 3999950]])),
         JaxPolygon(np.array([[500070, 3999930], [500110, 3999930], [500110, 3999905],
                              [500070, 3999905]])),
         JaxPolygon(np.array([[500002, 3999920], [500030, 3999940], [500020, 3999905]]))],
        {"species": ["oak", "pine", "fir"]}, epsg=32611).to_file(path)


def _ortho(path, bands):
    rng = np.random.default_rng(0)
    shape = (100, 120) if bands is None else (100, 120, bands)
    data = rng.integers(0, 255, shape).astype(np.uint8)
    if bands == 4:
        data[:50, :60, 3] = 0  # nodata: whole chips there are skipped
    jax_write_geotiff(path, JaxRaster(data, TRANSFORM, epsg=32611))


def _same_files(a: Path, b: Path):
    names = sorted(p.name for p in a.glob("*"))
    assert names == sorted(p.name for p in b.glob("*")) and names
    for name in names:
        with Image.open(a / name) as x, Image.open(b / name) as y:
            assert x.mode == y.mode
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    return names


@pytest.mark.parametrize("bands", [None, 3, 4])
@pytest.mark.parametrize("labels", [
    dict(label_column="species"),
    dict(label_column="species", write_empty_tile_if_no_labels=False),
    dict(label_column="species", label_remap={"oak": 3, "pine": 7}),
    dict(),
    None,
])
def test_write_chips_match_jax(bands, labels, tmp_path):
    _ortho(tmp_path / "ortho.tif", bands)
    _labels(tmp_path / "labels.geojson")
    kw = {} if labels is None else dict(labels, label_vector_file=tmp_path / "labels.geojson")
    want = jortho.write_chips(tmp_path / "ortho.tif", tmp_path / "jax", 48, 32, **kw)
    got = ortho.write_chips(tmp_path / "ortho.tif", tmp_path / "own", 48, 32, **kw)
    assert got == want
    names = _same_files(tmp_path / "own" / "imgs", tmp_path / "jax" / "imgs")
    if labels is not None:
        assert _same_files(tmp_path / "own" / "anns", tmp_path / "jax" / "anns") == names
    windows = list(ortho.create_windows((100, 120), 48, 32))
    skips_empty = labels is not None and "write_empty_tile_if_no_labels" in labels
    assert (len(names) < len(windows)) == (bands == 4 or skips_empty)


def _predictor_scene(tmp_path):
    """tests/test_predictors.py's round trip: the label chips as the
    predictions."""
    _ortho(tmp_path / "ortho.tif", 3)
    _labels(tmp_path / "labels.geojson")
    ortho.write_chips(tmp_path / "ortho.tif", tmp_path / "chips", 48, 32,
                      label_vector_file=tmp_path / "labels.geojson", label_column="species")
    return sorted((tmp_path / "chips" / "anns").glob("*.png")), 3


def _overlap_scene(tmp_path):
    """Seeded predictions of chips 40 px wide at a 10 px stride (4-way
    overlap along each axis, 16-way at a pixel), nodata patches and a few
    .npy files: the uint8 counts saturate at 255."""
    rng = np.random.default_rng(11)
    jax_write_geotiff(tmp_path / "ortho.tif", JaxRaster(
        np.zeros((70, 90, 3), np.uint8), TRANSFORM, epsg=32611))
    files = []
    for k, w in enumerate(ortho.create_windows((70, 90), 40, 10)):
        pred = rng.integers(0, 5, (w["height"], w["width"])).astype(np.uint8)
        pred[rng.random(pred.shape) < 0.1] = 255
        if k % 4 == 0:
            pred[: w["height"] // 2] = 255
        suffix = ".npy" if k % 7 == 0 else ".png"
        path = tmp_path / "preds" / ortho.get_str_from_window(w, suffix)
        write_image(path, pred)
        files.append(path)
    return sorted(files), 5


@pytest.mark.parametrize("scene", ["predictors", "overlap"])
@pytest.mark.parametrize("kw", [dict(), dict(downweight_edge_frac=0.4,
                                             max_overlapping_tiles=2),
                                dict(count_dtype=np.uint16, max_overlapping_tiles=16)])
def test_assembly_bit_equal_to_jax(scene, kw, tmp_path):
    files, n_classes = (_predictor_scene if scene == "predictors" else _overlap_scene)(
        tmp_path)
    jortho.assemble_tiled_predictions(tmp_path / "ortho.tif", files, n_classes,
                                      tmp_path / "jc.tif",
                                      counts_savefile=tmp_path / "jn.tif", **kw)
    stats = {}
    ortho.assemble_tiled_predictions(tmp_path / "ortho.tif", files, n_classes,
                                     tmp_path / "tc.tif", counts_savefile=tmp_path / "tn.tif",
                                     device="cpu", stats=stats, **kw)
    ortho.assemble_tiled_predictions_plain(tmp_path / "ortho.tif", files, n_classes,
                                           tmp_path / "pc.tif",
                                           counts_savefile=tmp_path / "pn.tif", **kw)
    for name in ("c", "n"):
        want = jax_read_geotiff(tmp_path / f"j{name}.tif")
        for got in (read_geotiff(tmp_path / f"t{name}.tif"),
                    read_geotiff(tmp_path / f"p{name}.tif")):
            assert got.data.dtype == want.data.dtype
            np.testing.assert_array_equal(got.data, want.data)
            assert got.transform == tuple(want.transform) and got.epsg == want.epsg
            assert got.nodata == want.nodata
    classes = read_geotiff(tmp_path / "tc.tif").data
    assert (classes == 255).any() and (classes < n_classes).any()
    if scene == "overlap" and not kw:
        counts = jax_read_geotiff(tmp_path / "jn.tif").data
        assert counts.max() > 255  # some class of some pixel saturated
    assert stats["counts_bytes"] == 70 * 90 * 5 * (
        1 if "count_dtype" not in kw else 4) or scene == "predictors"
    assert set(stats) >= {"read_s", "upload_s", "accumulate_s", "argmax_s",
                          "download_s", "write_s"}


def test_predictions_equal_the_burned_labels(tmp_path):
    """tests/test_predictors.py's checks on the port: the label chips
    assemble to the labels where observed, nodata elsewhere."""
    files, n = _predictor_scene(tmp_path)
    ortho.assemble_tiled_predictions(tmp_path / "ortho.tif", files, n,
                                     tmp_path / "a.tif", device="cpu")
    merged = read_geotiff(tmp_path / "a.tif")
    mapping = {"fir": 0, "oak": 1, "pine": 2}
    assert merged.data[30, 30] == mapping["oak"]
    assert merged.data[80, 90] == mapping["pine"]
    assert merged.data[5, 5] == 255


@pytest.mark.parametrize("bad", [5, 200])
def test_out_of_range_class_raises(bad, tmp_path):
    files, n = _overlap_scene(tmp_path)
    pred = np.zeros((40, 40), np.uint8)
    pred[3, 4] = bad
    write_image(files[1], pred) if files[1].suffix == ".png" else np.save(files[1], pred)
    for fn, kw in ((ortho.assemble_tiled_predictions, dict(device="cpu")),
                   (ortho.assemble_tiled_predictions_plain, {})):
        with pytest.raises(ValueError, match="outside classes 0..4"):
            fn(tmp_path / "ortho.tif", files, n, tmp_path / "x.tif", **kw)


def test_window_mismatch_raises(tmp_path):
    files, n = _overlap_scene(tmp_path)
    write_image(files[2].with_suffix(".png"), np.zeros((3, 3), np.uint8))
    with pytest.raises(ValueError, match="does not match"):
        ortho.assemble_tiled_predictions(tmp_path / "ortho.tif",
                                         [files[2].with_suffix(".png")], n,
                                         tmp_path / "x.tif", device="cpu")


def test_assembly_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    files, n = _overlap_scene(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ortho.assemble_tiled_predictions(tmp_path / "ortho.tif", files, n,
                                         tmp_path / "x.tif")


def test_assemble_entry_point_over_a_folder(tmp_path):
    files, n = _overlap_scene(tmp_path)
    assemble_ortho_predictions(tmp_path / "preds", raster_file=tmp_path / "ortho.tif",
                               num_classes=n, class_savefile=tmp_path / "e.tif",
                               device="cpu")
    jortho.assemble_tiled_predictions(tmp_path / "ortho.tif",
                                      sorted((tmp_path / "preds").glob("*")), n,
                                      tmp_path / "j.tif")
    np.testing.assert_array_equal(read_geotiff(tmp_path / "e.tif").data,
                                  jax_read_geotiff(tmp_path / "j.tif").data)


@pytest.mark.parametrize("module", ["chip_ortho", "assemble_ortho_predictions"])
def test_ortho_clis_answer_help(module):
    out = subprocess.run(
        [sys.executable, "-m", f"geograypher_tpu_torch.entrypoints.{module}", "--help"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin:/usr/local/bin", "PYTHONPATH": str(ROOT),
             "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-500:]
    assert "--raster-file" in out.stdout
    if module == "assemble_ortho_predictions":
        assert "--device" in out.stdout and "--pred-folder" in out.stdout


def test_ortho_entry_points_registered_and_parse(monkeypatch):
    from geograypher_tpu.entrypoints import assemble_ortho_predictions as jax_cli
    from geograypher_tpu_torch import entrypoints
    from geograypher_tpu_torch.entrypoints import assemble_ortho_predictions as cli

    assert {"chip_ortho", "assemble_ortho_predictions"} <= set(entrypoints.__all__)
    assert entrypoints.__getattr__("chip_ortho") is ortho.write_chips
    assert entrypoints.__getattr__("assemble_ortho_predictions") is (
        assemble_ortho_predictions)
    argv = ["x", "--raster-file", "r", "--pred-folder", "p", "--num-classes", "3",
            "--class-savefile", "c"]
    monkeypatch.setattr(sys, "argv", argv)
    want = vars(jax_cli.parse_args())
    got = vars(cli.parse_args())
    assert got.pop("device") == "cuda" and got == want
