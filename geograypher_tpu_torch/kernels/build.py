"""Build and load the port's hand-written CUDA kernels.

At first use, every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``
(one ``nvcc`` per source, all started together) and linked into one
shared library with a plain C interface,
``build/torch_kernels/libgg_torch_kernels.so`` under the repository root,
and loaded with ``ctypes``.  A SHA-256 of the sources and the compiler
flags is written beside the library, so an unchanged tree does not
rebuild.  Nothing here runs when the module is imported: the CPU tests
never need ``nvcc``.

Every C entry point takes its pointers and the CUDA stream as
``void*`` and returns the ``cudaGetLastError()`` of its launch; the
wrappers raise through :func:`check` when it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
LIB_NAME = "libgg_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float
_D = ctypes.c_double
# argtypes of every C entry point: an undeclared pointer would be cut to
# 32 bits by ctypes
SIGNATURES = {
    # planes, bbox, cand0..cand3, cnt0..cnt3, s_w, s_id (null: no level-S
    # carry), out, n_faces, H, W, tile_h, tile_w, nty0, ntx0, nty1, ntx1,
    # nty2, ntx2, s1, s2, c0, c1, c2, c3, stream
    "gg_raster_tiles": [_P] * 13 + [_I64] + [_I] * 16 + [_P],
    # planes, bbox, cells, s_unit, keys, best_w, best_id, n_faces, H, W,
    # sh, sw, s_block, stream
    "gg_s_raster": [_P] * 7 + [_I64] + [_I] * 5 + [_P],
    # pix2face, class_image, counts, H, W, n_faces, n_classes, stream
    "gg_face_class_counts": [_P, _P, _P, _I, _I, _I64, _I, _P],
    # image, class_image, violations, n_pix, n_classes, is_double, stream
    "gg_onehot_class": [_P, _P, _P, _I64, _I, _I, _P],
    # keys, keys_64, values, n, H, W, tw_shift, n_segments, n_channels,
    # scratch, sums, counts, stream
    "gg_face_sums": [_P, _I, _P, _I64, _I, _I, _I, _I64, _I, _P, _P, _P, _P],
    # soa, n, w2c, f_dev, f_host, dist, pcx_dev, pcy_dev, znear, W, H, out
    # (planes, bbox, valid in one buffer), device, stream
    "gg_triangle_setup": [_P, _I64, _P, _P, _D, _P, _P, _P, _F, _I, _I, _P, _I, _P],
    # bbox, valid, exclude, n_units, bin_block, global_from, (th, tw, ntx) x 3,
    # n_tiles x 3, wy0, wx0, caps x 4, (cand, counts, face_cand, face_counts)
    # x 4, scratch, census_only, stats, stream
    "gg_tile_binning": [_P, _P, _P, _I64, _I, _I64] + [_I] * 18 + [_P] * 17
                       + [_I, _P, _P],
    # n, n_segments, n_channels -> bytes
    "gg_face_sums_scratch_bytes": [_I64, _I64, _I],
}
# entry points that return something other than a CUDA error code
RESTYPES = {"gg_face_sums_scratch_bytes": ctypes.c_int64}

_lib: Optional[ctypes.CDLL] = None
# seconds the last build took (0.0 when the library was up to date)
last_build_seconds = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found on PATH or under /usr/local/cuda/bin: the CUDA "
        "kernels of geograypher_tpu_torch are built at first use"
    )


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def sources_digest() -> str:
    """SHA-256 over the kernel sources (names and bytes) and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile the kernel library unless an up-to-date one exists."""
    global last_build_seconds
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = sources_digest()
    if lib_path.exists() and stamp.exists() and stamp.read_text() == digest:
        last_build_seconds = 0.0
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    # build under private names, then rename: concurrent processes never
    # load a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        jobs = []
        for src in sorted(CSRC_DIR.glob("*.cu")):
            obj = Path(tmp_dir) / (src.stem + ".o")
            jobs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        log, failed = [], []
        for src, _, proc in jobs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        tmp_lib = Path(tmp_dir) / LIB_NAME
        if not failed:
            link = subprocess.run(
                [nvcc, "-shared", "-o", str(tmp_lib), *(str(o) for _, o, _ in jobs)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            log.append(f"== link\n{link.stdout}")
            if link.returncode != 0:
                failed.append("link")
        (BUILD_DIR / "nvcc.log").write_text("".join(log))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "".join(log))
        os.replace(tmp_lib, lib_path)
    stamp.write_text(digest)
    last_build_seconds = time.perf_counter() - t0
    return lib_path


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = RESTYPES.get(name, ctypes.c_int)
        lib.gg_error_string.argtypes = [ctypes.c_int]
        lib.gg_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if err != 0:
        msg = load().gg_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def stream_ptr(device) -> int:
    """The current CUDA stream of ``device`` as a pointer-sized int."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def raw_stream(index: int) -> int:
    """The current CUDA stream of device ``index`` as a pointer-sized int,
    with no ``torch.cuda.Stream`` built: a few microseconds less than
    ``stream_ptr`` a call, through a private PyTorch function, which only
    this module calls."""
    import torch

    return torch._C._cuda_getCurrentRawStream(index)
