"""Sparse aggregation for huge discrete label spaces, in PyTorch.

Port of ``geograypher_tpu/meshes/sparse.py`` (the reference's
``TexturedPhotogrammetryMeshIndexPredictions``,
derived_meshes.py:414-550): when the "classes" are per-detection
instances or per-image ids (tens of thousands to millions), a dense
(faces x classes) accumulator is infeasible.

Per view, on the mesh's device: the pix2face raster, the remap of the
view's global ids to a compact local set (``unique`` and
``searchsorted``, O(pixels)), the counts kernel
(``ops/face_counts.py``) at (F, n_local), and ``nonzero`` there, so that
only the (face, class, count) triples and the seen faces come to the
host, never the (F, n_local) table (1.2 GB a view at 999,698 faces and
300 detections).  The host accumulates the CSR as the JAX package does.

Each stage of :func:`aggregate_index_predictions` is a span
(``utils/profiling.py``: a ``perf_counter`` total, and a
``record_function`` only while a profiler records; no span waits for the
device), and each call logs one INFO record of this module's logger whose
``sparse_stats`` dict holds the call's totals (see the function).
:func:`sparse_argmax` opens ``sparse.argmax``.
"""

from __future__ import annotations

import logging
import time
import typing

import numpy as np
import scipy.sparse
import torch

from geograypher_tpu_torch.cameras.core import CameraSet
from geograypher_tpu_torch.meshes.mesh import TexturedMesh
from geograypher_tpu_torch.ops.face_counts import face_class_counts
from geograypher_tpu_torch.utils.device import PinnedUpload
from geograypher_tpu_torch.utils.profiling import _StageTimer, annotate

logger = logging.getLogger(__name__)

#: the spans of :func:`aggregate_index_predictions`, in the order of a view
SPANS = ("segment", "upload", "remap", "pix2face", "table", "download", "host",
         "csr")


def local_class_image(img: torch.Tensor):
    """(int32 (H, W) local ids, -1 where the image is not finite; int64
    (n_local,) global ids): the view's global ids remapped to a compact
    sorted set, as the JAX package's ``np.unique`` + ``searchsorted``
    (the unique values taken before the cast to int64, as there)."""
    finite = torch.isfinite(img)
    values = img[finite]
    local_classes = torch.unique(values).long()
    local = torch.full(img.shape, -1, dtype=torch.int32, device=img.device)
    local[finite] = torch.searchsorted(local_classes, values.long()).to(torch.int32)
    return local, local_classes


def aggregate_index_predictions(
    mesh: TexturedMesh,
    cameras: CameraSet,
    n_classes: int,
    aggregate_img_scale: float = 1.0,
    check_null_image: bool = True,
    stats: typing.Optional[list] = None,
    **pix2face_kwargs,
) -> typing.Tuple[scipy.sparse.csr_array, np.ndarray]:
    """Accumulate sparse per-face class counts across views.

    Args:
        mesh: the textured mesh; the per-view work runs on its device.
        cameras: camera set whose images are detection-index rasters
            (NaN = background, else global class/detection index).
        n_classes: total number of global classes/detections.
        stats: a list that, when given, gets one dict of seconds per view
            (``segment_s``, the segmentor's image on the host;
            ``upload_s``, ``remap_s``, ``pix2face_s``, ``counts_s``,
            ``nonzero_s``, ``download_s``, ``host_s``), each stage ended
            by a synchronise.

    One INFO log record of this module's logger carries the call's totals
    as its ``sparse_stats`` dict: ``seconds`` (the whole call), ``views``
    (the cameras handed in), ``local_classes`` (the views' ``n_local``
    added up), ``table_bytes`` (the (F, n_local) int32 tables' bytes added
    up), ``triples`` (the (face, class, count) triples downloaded), and
    for each span ``sparse.<name>`` its seconds as ``<name>_s``:
    ``segment`` (the segmentor's image on the host), ``upload``,
    ``remap`` (the local ids: ``unique`` waits for the card), ``pix2face``
    (the raster chain and its overflow read), ``table`` (the counts launch,
    ``nonzero`` over the table and the seen faces, each ``nonzero`` a wait
    for the card), ``download``, ``host`` (the per-view appends) and
    ``csr`` (the final CSR).  The spans never synchronise; with ``stats``
    the synchronises above fall inside them.

    Returns:
        counts: (n_faces, n_classes) float32 CSR of pixel counts
        faces_seen: (n_faces,) number of views seeing each face
    """
    t_call = time.perf_counter()
    n_faces = mesh.n_faces
    device = mesh.device
    rows, cols, vals = [], [], []
    faces_seen = np.zeros(n_faces)
    upload = PinnedUpload(device)
    timer = _StageTimer()
    totals = dict(local_classes=0, table_bytes=0, triples=0)

    def mark():
        if stats is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    for i in range(len(cameras)):
        t_seg = time.perf_counter()
        with timer("sparse.segment"):
            img = cameras.get_image_by_index(i, aggregate_img_scale)
            img = np.asarray(img, dtype=np.float64)
            if img.ndim == 3:
                img = img[..., 0]
            t0 = mark()
        with timer("sparse.upload"):
            img_dev = upload(img)
            t1 = mark()
        with timer("sparse.remap"):
            local, local_classes = local_class_image(img_dev)
            n_local = int(local_classes.numel())
            skip = check_null_image and n_local == 0
            t2 = None if skip else mark()
        if skip:
            continue
        with timer("sparse.pix2face"):
            p2f = mesh._pix2face_device(
                cameras, i, render_img_scale=aggregate_img_scale, **pix2face_kwargs
            )
            t3 = mark()
        n_local = max(n_local, 1)
        if n_faces * n_local + 1 >= 2**31:
            raise ValueError(
                f"n_faces * n_classes = {n_faces * n_local} overflows the "
                "int32 flattened segment index — aggregate class subsets in "
                "chunks (e.g. via meshes/sparse.py's per-view local remap)"
            )
        with timer("sparse.table"):
            counts = face_class_counts(p2f.to(torch.int32).contiguous(), local,
                                       n_faces, n_local)
            t4 = mark()
            f_idx, c_idx = torch.nonzero(counts, as_tuple=True)
            v = counts[f_idx, c_idx]
            del counts
            seen = torch.zeros(n_faces, dtype=torch.bool, device=device)
            seen[p2f[p2f >= 0].long()] = True
            seen = torch.nonzero(seen, as_tuple=True)[0]
            t5 = mark()
        with timer("sparse.download"):
            f_idx, c_idx, v, seen, local_classes = (
                t.cpu().numpy() for t in (f_idx, c_idx, v, seen, local_classes))
            t6 = mark()
        with timer("sparse.host"):
            rows.append(f_idx)
            cols.append(local_classes[c_idx])
            vals.append(v.astype(np.float32))
            faces_seen[seen] += 1
        totals["local_classes"] += n_local
        totals["table_bytes"] += n_faces * n_local * 4
        totals["triples"] += len(f_idx)
        if stats is not None:
            stats.append(dict(segment_s=t0 - t_seg, upload_s=t1 - t0, remap_s=t2 - t1,
                              pix2face_s=t3 - t2, counts_s=t4 - t3,
                              nonzero_s=t5 - t4, download_s=t6 - t5,
                              host_s=time.perf_counter() - t6))
    with timer("sparse.csr"):
        if rows:
            counts = scipy.sparse.csr_array(
                (
                    np.concatenate(vals),
                    (np.concatenate(rows), np.concatenate(cols)),
                ),
                shape=(n_faces, n_classes),
            )
        else:
            counts = scipy.sparse.csr_array((n_faces, n_classes))
    record = dict(seconds=time.perf_counter() - t_call, views=len(cameras), **totals,
                  **{f"{name}_s": timer.seconds(f"sparse.{name}") for name in SPANS})
    logger.info("sparse: %d views, %d triples in %.3f s", record["views"],
                record["triples"], record["seconds"],
                extra={"sparse_stats": record})
    return counts, faces_seen


def normalize_sparse_counts(
    counts: scipy.sparse.csr_array,
    faces_seen: typing.Optional[np.ndarray] = None,
) -> scipy.sparse.csr_array:
    """Per-face reciprocal normalization of a CSR count matrix.

    With ``faces_seen`` (the views-seeing-each-face vector from
    :func:`aggregate_index_predictions`), counts divide by the VIEW
    count, the reference's semantics (derived_meshes.py:522-548: summed
    projections x reciprocal projection_counts).  Without it, each face's
    counts divide by its own total, so rows sum to 1 (pixel-fraction
    normalization).
    """
    if faces_seen is not None:
        totals = np.asarray(faces_seen, dtype=float).reshape(-1)
    else:
        totals = np.asarray(counts.sum(axis=1)).reshape(-1)
    inv = np.zeros_like(totals)
    nz = totals > 0
    inv[nz] = 1.0 / totals[nz]
    d = scipy.sparse.diags_array(inv)
    return (d @ counts).tocsr()


def sparse_argmax(counts: scipy.sparse.csr_array) -> np.ndarray:
    """Per-face argmax class over a CSR count matrix; NaN for empty rows.

    Vectorized (segmented reduceat over the CSR structure); ties break
    toward the first stored (lowest) class index, like np.argmax.
    Span ``sparse.argmax``.
    """
    with annotate("sparse.argmax"):
        counts = counts.tocsr()
        out = np.full(counts.shape[0], np.nan)
        row_nnz = np.diff(counts.indptr)
        rows = np.nonzero(row_nnz > 0)[0]
        if rows.size == 0:
            return out
        starts = counts.indptr[rows]
        row_max = np.maximum.reduceat(counts.data, starts)
        # first position per row whose value equals the row max
        pos = np.arange(counts.data.size)
        pos = np.where(
            counts.data == np.repeat(row_max, row_nnz[rows]), pos, counts.data.size
        )
        first = np.minimum.reduceat(pos, starts)
        out[rows] = counts.indices[first]
        return out
