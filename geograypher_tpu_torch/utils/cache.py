"""Hash-keyed disk cache for pix2face maps.

Port of ``geograypher_tpu/utils/cache.py`` with the same file layout, so
either package reads what the other wrote: ``MAGIC | ndim (int64) | shape
(ndim int64) | (int32 value, uint32 run length) pairs``.  Face-id maps are
long runs, so the run-length code makes them 10-50x smaller.  The codec
here is numpy (the JAX package's is C++): run boundaries from
``np.flatnonzero(np.diff(...))``, decoding with ``np.repeat``.
"""

from __future__ import annotations

import hashlib
import logging
from pathlib import Path
from typing import Optional

import numpy as np

from geograypher_tpu_torch.constants import CACHE_FOLDER, PATH_TYPE
from geograypher_tpu_torch.utils.files import ensure_folder

logger = logging.getLogger(__name__)

MAGIC = b"GGRLE001"
_PAIR = np.dtype([("value", "<i4"), ("run", "<u4")])


def rle_encode(arr: np.ndarray) -> bytes:
    """(int32 value, uint32 run) pairs of the flattened array."""
    flat = np.ascontiguousarray(arr, dtype=np.int32).reshape(-1)
    if flat.size > 0xFFFFFFFF:
        raise ValueError("arrays over 2^32 - 1 elements are not run-length coded")
    if flat.size == 0:
        return b""
    starts = np.concatenate([[0], np.flatnonzero(np.diff(flat)) + 1])
    pairs = np.empty(starts.size, _PAIR)
    pairs["value"] = flat[starts]
    pairs["run"] = np.diff(np.append(starts, flat.size))
    return pairs.tobytes()


def rle_decode(payload: bytes, n: int) -> np.ndarray:
    """The ``n`` int32 values of an :func:`rle_encode` payload."""
    pairs = np.frombuffer(payload, _PAIR, count=len(payload) // _PAIR.itemsize)
    if int(pairs["run"].sum(dtype=np.int64)) != n:
        raise ValueError("run lengths do not add up to the array's size")
    return np.repeat(pairs["value"].astype(np.int32), pairs["run"])


def _key_path(cache_folder: Path, name: str, depends: list) -> Path:
    hasher = hashlib.sha256()
    for d in depends:
        hasher.update(repr(d).encode())
    return Path(cache_folder) / f"{name}_{hasher.hexdigest()[:32]}.ggr"


def save_pix2face(
    pix2face: np.ndarray,
    name: str,
    depends: list,
    cache_folder: PATH_TYPE = CACHE_FOLDER,
) -> Path:
    ensure_folder(cache_folder)
    path = _key_path(Path(cache_folder), name, depends)
    arr = np.ascontiguousarray(pix2face, dtype=np.int32)
    with open(path, "wb") as fh:
        fh.write(MAGIC)
        fh.write(np.int64(arr.ndim).tobytes())
        fh.write(np.asarray(arr.shape, dtype=np.int64).tobytes())
        fh.write(rle_encode(arr))
    return path


def load_pix2face(
    name: str,
    depends: list,
    cache_folder: PATH_TYPE = CACHE_FOLDER,
) -> Optional[np.ndarray]:
    """Load a cached map; on any error the entry is cleared and None
    returned.  Also reads the ``.npz`` entry the JAX package writes when
    its native codec is unavailable."""
    path = _key_path(Path(cache_folder), name, depends)
    npz = path.with_suffix(".npz")
    try:
        if path.exists():
            raw = path.read_bytes()
            if raw[:8] != MAGIC:
                raise ValueError("bad magic")
            ndim = int(np.frombuffer(raw[8:16], dtype=np.int64)[0])
            shape = tuple(
                int(s) for s in np.frombuffer(raw[16: 16 + 8 * ndim], dtype=np.int64)
            )
            return rle_decode(raw[16 + 8 * ndim:], int(np.prod(shape))).reshape(shape)
        if npz.exists():
            return np.load(npz)["pix2face"]
    except Exception as exc:  # corrupt entry: clear and recompute
        logger.warning("clearing corrupt cache entry %s (%s)", path, exc)
        for p in (path, npz):
            try:
                p.unlink(missing_ok=True)
            except OSError:
                pass
    return None
