"""``TexturedMesh.save_renders``' mask writer (its pool of host threads)
and ``utils/io.py`` ``encode_png``, on the CPU: the files equal those of
serial ``write_image`` calls on the same masks, a repeated file name keeps
the later view's file, overflowed views and failed writes are raised as a
serial loop raises them, and no writer thread outlives the call; the PNG
bytes equal the previous construction's and decode to the input."""

import struct
import threading
import time
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import png as reference_png
from geograypher_tpu_torch.cameras.core import CameraSet
from geograypher_tpu_torch.meshes import mesh as mesh_module
from geograypher_tpu_torch.meshes.mesh import TexturedMesh, _MaskWriter
from geograypher_tpu_torch.utils import io
from geograypher_tpu_torch.utils.fixtures import (
    make_grid_mesh,
    nadir_camera,
    oblique_camera,
)
from tests.test_torch_rasterize import one_torch_thread  # noqa: F401

W, H = 96, 64
N_VIEWS = 5
write_image = io.write_image  # the real writer, before any monkeypatch


@pytest.fixture(scope="module")
def scene():
    """A 21 x 21-vertex grid with seeded face classes (some unlabelled)
    and five views named after their images, the last at another focal
    length and size."""
    verts, faces = make_grid_mesh(
        n=21, size=4.0, z_fn=lambda x, y: 0.1 * np.sin(3 * x) * np.cos(2 * y))
    rng = np.random.default_rng(11)
    labels = rng.integers(0, 6, len(faces)).astype(float)
    labels[rng.random(len(faces)) < 0.15] = np.nan
    mesh = TexturedMesh((verts, faces), texture=labels[:, None], device="cpu")
    mesh.spatial_sort_faces()
    c2ws = [nadir_camera(4.0, 60.0, W),
            oblique_camera(4.0, 60.0, W, pitch_deg=25.0, azimuth_deg=30.0),
            nadir_camera(3.0, 60.0, W),
            oblique_camera(4.0, 60.0, W, pitch_deg=30.0, azimuth_deg=200.0),
            nadir_camera(4.0, 50.0, 80)]
    sensors = {0: {"f": 60.0, "cx": 0.0, "cy": 0.0, "image_width": W, "image_height": H},
               1: {"f": 50.0, "cx": 0.0, "cy": 0.0, "image_width": 80, "image_height": 48}}
    cams = CameraSet(c2ws, sensors, sensor_IDs=[0, 0, 0, 0, 1],
                     image_filenames=[f"view_{k}.JPG" for k in range(N_VIEWS)])
    return verts, faces, labels, mesh, cams


def _recorder(calls):
    def record(path, array):
        calls.append((path, array, threading.current_thread().name))
        return 0
    return record


def _files(folder):
    return {p.name: p.read_bytes() for p in sorted(folder.iterdir())}


@pytest.mark.parametrize("kind", ["gray", "bgr", "npy", "half_native"])
def test_files_equal_serial_writes(scene, tmp_path, monkeypatch, kind):
    """Every file equals a serial ``write_image`` of the mask the writer
    was handed, a host array handed to a writer thread: gray PNG, the
    3-channel texture in cv2's channel order, ``.npy`` and a half-scale
    render enlarged to the sensor's size."""
    verts, faces, labels, mesh, cams = scene
    if kind == "bgr":
        rgb = np.random.default_rng(3).random((len(faces), 3)) * 300 - 20
        mesh = TexturedMesh((verts, faces), texture=rgb, device="cpu")
        mesh.spatial_sort_faces()
    kw = {"npy": dict(output_extension=".npy"),
          "half_native": dict(render_image_scale=0.5, save_native_resolution=True)
          }.get(kind, {})
    mesh.save_renders(cams, output_folder=tmp_path / "pool", **kw)
    calls = []
    monkeypatch.setattr(mesh_module, "write_image", _recorder(calls))
    mesh.save_renders(cams, output_folder=tmp_path / "record", **kw)
    assert len(calls) == N_VIEWS
    for path, array, thread in calls:
        assert isinstance(array, np.ndarray) and thread.startswith("mask-writer")
        write_image(tmp_path / "serial" / path.name, array)
    pool, serial = _files(tmp_path / "pool"), _files(tmp_path / "serial")
    suffix = ".npy" if kind == "npy" else ".png"
    assert sorted(pool) == [f"view_{k}{suffix}" for k in range(N_VIEWS)]
    assert pool == serial
    shapes = {a.shape[:2] for _, a, _ in calls}
    assert shapes == {(H, W), (48, 80)}
    if kind == "bgr":
        assert all(a.shape == (*a.shape[:2], 3) for _, a, _ in calls)


def test_repeated_name_keeps_the_later_view(scene, tmp_path, monkeypatch):
    """Two views with one image name leave the later view's file, however
    long the earlier view's write takes."""
    _, _, _, mesh, cams = scene
    twice = cams.get_subset_cameras([0, 1])
    twice.image_filenames = [Path("same.JPG")] * 2
    later = cams.get_subset_cameras([1])
    later.image_filenames = [Path("same.JPG")]
    mesh.save_renders(later, output_folder=tmp_path / "later")
    seen = []

    def slow_first(path, array):
        seen.append(path)
        if len(seen) == 1:
            time.sleep(0.3)
        return write_image(path, array)

    monkeypatch.setattr(mesh_module, "write_image", slow_first)
    mesh.save_renders(twice, output_folder=tmp_path / "twice")
    assert len(seen) == 2
    assert _files(tmp_path / "twice") == _files(tmp_path / "later")


def _fake_renders(overflows):
    """A ``_render_flat_device`` of constant 1-channel images, view k's
    pixels k, with the given overflow counts."""
    def renders(cameras, scale, kwargs):
        for k, dropped in enumerate(overflows):
            yield (torch.full((H, W, 1), float(k)),
                   torch.tensor(dropped, dtype=torch.int64))
    return renders


def _slow_writes(delay, fail=()):
    """A ``write_image`` that sleeps ``delay[view]`` seconds, then raises
    for the views in ``fail`` and writes the others."""
    def write(path, array):
        view = int(path.stem.split("_")[1])
        time.sleep(delay.get(view, 0.0))
        if view in fail:
            raise OSError(f"disk full at view {view}")
        return write_image(path, array)
    return write


def test_overflowed_views_raise_after_every_other_file(scene, tmp_path, monkeypatch):
    """An overflowed view writes no file; the error naming it comes after
    the last view, once every other file is on disk, and no writer thread
    is left."""
    _, _, _, mesh, cams = scene
    monkeypatch.setattr(mesh, "_render_flat_device", _fake_renders([0, 0, 3, 0, 0]))
    monkeypatch.setattr(mesh_module, "write_image",
                        _slow_writes({k: 0.1 for k in range(N_VIEWS)}))
    threads = threading.active_count()
    with pytest.raises(RuntimeError, match=r"overflow in views \[2\]"):
        mesh.save_renders(cams, output_folder=tmp_path)
    assert sorted(_files(tmp_path)) == [f"view_{k}.png" for k in (0, 1, 3, 4)]
    for k in (0, 1, 3, 4):
        assert (io.decode_png((tmp_path / f"view_{k}.png").read_bytes()) == k).all()
    assert threading.active_count() == threads


def test_failed_write_is_raised_in_view_order(scene, tmp_path, monkeypatch):
    """A failed write is raised by the call, the first in view order even
    where a later view fails sooner; the views before it are on disk, and
    no writer thread outlives the call."""
    _, _, _, mesh, cams = scene
    monkeypatch.setattr(mesh, "_render_flat_device", _fake_renders([0] * N_VIEWS))
    monkeypatch.setattr(mesh_module, "write_image",
                        _slow_writes({1: 0.4}, fail=(1, 3)))
    threads = threading.active_count()
    with pytest.raises(OSError, match="at view 1"):
        mesh.save_renders(cams, output_folder=tmp_path)
    assert {"view_0.png"} <= set(_files(tmp_path)) <= {"view_0.png", "view_2.png",
                                                      "view_4.png"}
    assert threading.active_count() == threads


def test_writer_bounds_the_files_in_flight(tmp_path, monkeypatch):
    """At most twice the pool's threads of files are pending, and the
    pool has 1 to 8 threads by the CPUs the process may run on."""
    writer_threads = []
    for cpus in (1, 2, 5, 64):
        monkeypatch.setattr(mesh_module.os, "sched_getaffinity",
                            lambda pid, n=cpus: set(range(n)), raising=False)
        with _MaskWriter() as writer:
            writer_threads.append(writer.threads)
    assert writer_threads == [1, 1, 4, 8]
    release = threading.Event()
    monkeypatch.setattr(mesh_module, "write_image",
                        lambda path, array: release.wait(5.0))
    with _MaskWriter() as writer:
        for k in range(2 * writer.threads):
            writer.submit(tmp_path / f"v{k}.png", np.zeros((2, 2), np.uint8))
        assert len(writer._pending) == 2 * writer.threads
        threading.Timer(0.2, release.set).start()
        t0 = time.perf_counter()
        writer.submit(tmp_path / "one_more.png", np.zeros((2, 2), np.uint8))
        assert time.perf_counter() - t0 >= 0.1  # it waited for the oldest
        assert len(writer._pending) <= 2 * writer.threads


# -- encode_png ------------------------------------------------------------------


def previous_encode_png(image, level=io.PNG_ZLIB_LEVEL):
    """The construction ``encode_png`` had before it filled the rows in
    one copy: a contiguous big-endian copy, the rows copied behind the
    filter bytes, and the bytes of that buffer compressed."""
    img = np.asarray(image)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.dtype == np.bool_:
        img = img.astype(np.uint8) * 255
    color_type = 0 if img.ndim == 2 else (2 if img.shape[2] == 3 else 6)
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">")))
    rows = rows.view(np.uint8).reshape(h, -1)
    raw = np.empty((h, rows.shape[1] + 1), np.uint8)
    raw[:, 0] = 0
    raw[:, 1:] = rows
    header = struct.pack(">IIBBBBB", w, h, 8 * img.dtype.itemsize, color_type, 0, 0, 0)
    return (io.PNG_SIGNATURE + io._chunk(b"IHDR", header)
            + io._chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + io._chunk(b"IEND", b""))


def _images():
    rng = np.random.default_rng(29)
    mask = np.full((40, 70), 255, np.uint8)
    mask[5:30, 10:50] = rng.integers(0, 6, (25, 40))
    return {
        "uint8": mask,
        "uint16": rng.integers(0, 65536, (33, 47), dtype=np.uint16),
        "hw1": rng.integers(0, 256, (33, 47, 1), dtype=np.uint8),
        "rgb": rng.integers(0, 256, (33, 47, 3), dtype=np.uint8),
        "rgba": rng.integers(0, 256, (33, 47, 4), dtype=np.uint8),
        "bool": rng.random((33, 47)) < 0.4,
        "strided_bgr": rng.integers(0, 256, (66, 94, 3), dtype=np.uint8)[::2, ::2, ::-1],
        "strided_uint16": rng.integers(0, 65536, (33, 94), dtype=np.uint16)[:, 1::2],
    }


@pytest.mark.parametrize("kind", list(_images()))
@pytest.mark.parametrize("level", [1, 6])
def test_encode_png_bytes_unchanged(kind, level):
    """The same bytes as the previous construction, and a file that both
    PNG readers decode to the input (bool as 0 / 255; the reference
    reader takes 8-bit files only)."""
    image = _images()[kind]
    data = io.encode_png(image, level)
    assert data == previous_encode_png(image, level)
    want = image.astype(np.uint8) * 255 if image.dtype == np.bool_ else image
    if want.ndim == 3 and want.shape[2] == 1:
        want = want[..., 0]
    got = io.decode_png(data)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if want.dtype == np.uint8:
        np.testing.assert_array_equal(reference_png.decode(data), want)
    else:
        with pytest.raises(ValueError):
            reference_png.decode(data)


def test_encode_png_leaves_its_input_alone():
    image = _images()["strided_uint16"]
    before = image.copy()
    io.encode_png(image)
    np.testing.assert_array_equal(image, before)
    assert image.dtype == np.uint16 and not image.flags.c_contiguous
