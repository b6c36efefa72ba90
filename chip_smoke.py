"""Drive the PyTorch port's aggregation, render, detection, DTM, polygon, image-selection and ortho-prediction paths and its example scripts once on one CUDA card.

Run from the repository root, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits nonzero):

0. the card's name and power limit (nvidia-smi), torch and CUDA versions;
1. build the CUDA kernels from ``geograypher_tpu_torch/csrc``;
2. each kernel against its plain PyTorch version on the card, bit for
   bit, on the 999,698-face bench grid mesh at 3840x2160: a nadir view
   (f=2000) and an oblique view (f=2600, pitch 30 deg) at the main path's
   configuration, the nadir view again at ``bin_block=8`` (the
   configuration of the TPU's 8-face-unit fold), and a low oblique view
   whose near faces fill the L2 and global candidate lists (first the
   front end on each: the setup kernel and the binning kernels against
   ``setup_from_soa_plain`` and ``bin_triangles_plain``, planes as their
   int32 words, lists, counts, face lists, overflow and census, two
   binning runs equal, with their times, each kernel's device time by
   name and their bounds, ``"front"`` lines); the setup's fixed cost on
   1,024 faces (``"setup_probe"``: bit-equal, wrapper and device ms) and
   the host's time to enqueue a setup call, split into its parts
   (``"setup_host_us"``); then a knife-edge probe
   (``knife_edge_triangles``: vertices on and within 1e-4 px of pixel
   centres, axis-aligned edges, slivers, edges longer than 2^18 px)
   through the front end and both rasters at the main and the level-S
   configurations; two binning probes (``"binning_probe"``): tile lists
   longer than the cut kernel's shared sort (``crowded_tile_triangles``)
   and an 8192^2 grid past the count kernel's shared histogram; the counts kernel is timed on two label fields, one
   drawn independently per pixel and one constant over 64 x 64 pixel
   patches (what a segmentation looks like); then the one-hot scan
   kernel against its plain version and the numpy scan on view 0's
   one-hot image (float32, float64, with unlabeled rows) and on three
   images it must refuse, which ``project_images`` must send down the
   per-channel means path;
3. the main path: ``TexturedMesh.aggregate_projected_images`` over 8 4K
   views (6 pinhole, 2 Brown-Conrady) of seeded one-hot labels, with
   every kernel's launch count, the aggregate held equal to one built
   from the numpy scan's class images of the same views, then view 0
   re-run through the plain versions (bit for bit) and a small scene
   held against the numpy brute-force oracle; then each stage of one
   view's device chain timed alone (breakdown, views 0, 1 and 6, each
   view's front end held against its plain versions first);
4. level S: the sub-tile raster configuration (``bin_block=8``,
   ``subtile=(8, 16)``) -- its three kernels against their plain versions
   on the nadir and oblique 4K views, bit for bit; the S path of
   ``aggregate_projected_images`` over the same 8 views with every
   kernel's launch count; view 0's pix2face with level S on against the
   same configuration with it off; the unfused counts
   (``ops/agg_tiled.py``) on view 0's pix2face; and the stage breakdown
   of views 0/1/6 with level S on and off;
5. the render path, from a survey on disk (``"5a"``: the bench mesh as a
   binary PLY in a local frame, the suite's 8 cameras as a Metashape XML
   with a local -> ECEF transform, six seeded label polygons of four
   species in UTM as GeoJSON, all in a temporary folder): ``"5b"``, the
   ``render_labels`` entry point with ``device`` left at its default
   writes 8 PNG masks (8 raster launches, no other kernel, zero
   overflow); every file equals the mask rebuilt from its view's
   pix2face, holds 255 and at least two classes, view 0 and view 6
   (distorted) equal their re-runs through the plain raster and numpy's
   remap bit for bit, and a second cached ``pix2face`` reads the cache;
   ``"5b_view"`` times each view's stages (raster chain, remap, texture
   gather, cast on the device against the cast in numpy, download, PNG
   encode and write at zlib levels 1 and 6); ``"5c"``, the round trip:
   ``aggregate_images`` reads the rendered folder back and the predicted
   class of the observed, labelled faces must be the mesh's face texture
   for at least ``ROUND_TRIP_MIN_AGREE`` of them; 8 4K views take the
   planned route (printed);
6. planned aggregation (``parallel/planner.py``) over phase 3's 8 views at
   the bench's binning configuration (``bin_block=8, l0_window=(5, 2)``)
   and the library's default caps: the pooled counts equal the streaming
   chain's per-view counts summed, the planned route of
   ``aggregate_projected_images`` (one-hot scan on the card, int8 class
   images) its mean (view counts exactly, the mean to 1e-6), with one
   launch per view and kernel (no retry); a plan forced to caps (16, 16,
   16, 16) ends equal after its retry; it prints the census time, the
   buckets, views/s of the route, of int class images from a provider,
   and of one bucket against four; ``"6m"``: the means path (a soft image)
   twice on a pinhole and a distorted view, bit for bit, and the
   ``face_sums`` kernels against their plain version on view 0 and on the
   mesh's 3F vertex keys (``face_to_vert_texture``'s sum), with the
   wrapper's launches by name (no sort);
7. the survey pipeline (``parallel/pipeline.py``
   ``aggregate_class_images_distributed``) over 20 4K views of the bench
   suite (the last five through the Brown-Conrady sensors) at phase 6's
   configuration and default caps: with a provider of int class images,
   one launch per view and kernel, no retry, the view counts those of the
   planner's weighted path on the same labels and the fraction sums to
   ``PLANNED_MEAN_RTOL``; two runs ``torch.equal``; the default provider
   (the host argmax of the one-hot images) equal to it; caps (16, 16, 16,
   16) gated and re-run to the same result; two shards on the one card
   (the cross-device sum) equal to one to f32 rounding; it prints views/s
   at 1 and 4 prefetch workers for both providers, the host's seconds
   waiting on the workers and inside the uploads, the device's busy share
   over a run (``torch.profiler``), the host argmax in one thread against
   four, and the launches by kernel; ``"7c"``: ``aggregate_images_chunked``
   over the same views in two camera clusters whose buffers cover the
   scene (view counts equal to the unchunked route's), ``render_labels``
   with ``n_cameras_per_chunk=4`` on phase 5's survey (every PNG equal to
   phase 5's), and ``sharded_render_aggregate`` on phase 3's 8 views, on
   one and on two shards, against a loop of the raster chain,
   ``render_texture`` and ``project_image_to_faces``;
8. the detection workflow (``"8a"``: the bench mesh as PLY and phase 7's
   20 views as a Metashape XML; 300 seeded objects 0.1-0.4 m above the
   surface, each projected into every view it lies in front of as a
   40 x 40 px box of a CSV and a square of the view's GeoJSON): ``"8b"``,
   ``project_detections`` at full 4K, one raster and one counts launch a
   view, equal to a run of the same views through the plain versions and
   with counts for every detection whose centre sees the mesh, the
   raster and counts kernels against their plain versions on view 0 at
   its own (faces, detections) shape, with per-view stage times;
   ``"8c"``, ``multiview_detections`` (covering mesh N=50): every object
   seen in two or more views recovered within ``DETECTION_RECOVER_M``,
   no community farther than that from every object, the same points from
   a second run and from the cache files, and the stage times (rays,
   clip, the graph's device blocks and host formatting, Louvain,
   averaging);
9. GeoTIFF, DTM, the orthographic raster and polygons on phase 8's survey
   on disk: ``"9a"`` writes a 4096 x 4096 float32 DTM GeoTIFF (deflate,
   256 x 256 tiles) lying a known offset below the mesh in its UTM CRS,
   reads it with the port's codec, holds every vertex's height above
   ground against the offset within its sampling error, runs
   ``render_height_masks`` (PNG masks of the 20 views, float renders of
   every 5th: each mask equal to its render thresholded but within a
   face's height spread of a threshold) and ``aggregate_images`` with the
   DTM on the planned route (one launch a view and kernel; faces below the
   ground threshold relabelled, the others' classes back); ``"9b"``,
   ``ortho_pix2face`` at 1.6 mm (2551 x 2551 px, f ~1e5) on census-sized
   caps with zero overflow, the raster kernel bit-equal to its plain
   version there, the footprint again in 3 x 3 tiles (every pasted tile
   bit-equal to its plain version; the share equal to the untiled map a
   reading), both maps in windows and at every knife-edge hole against
   the float64 oracle at their own focal length, and a ~10000 px ortho in
   2 x 2 tiles (one tile against the plain version); ``"9c"``, phase 5's six star polygons painted on the mesh, the
   raster vector export, and the ``label_polygons`` entry point without
   and with the DTM and in the exact mode (every polygon no other overlaps
   labelled with its own species), with their stage times;
10. image selection and ortho predictions on the same survey folder:
   ``"10a"``, ``determine_minimum_overlapping_images`` over 200 4K cameras
   of the bench suite's pattern (a Metashape XML beside phase 5's mesh)
   at its default image scale 0.05 on census-sized caps (one raster and
   one counts launch a view, zero overflow; every 10th view's visibility
   equal to the plain raster and counts; the picks equal to the plain
   greedy over the dense matrix; every seen face covered), then
   ``"10a_full"``, the same over phase 8's 20 views at scale 1.0 (every
   view held against the plain run); ``"10b"``, phase 9b's ~10000 px
   ortho map coloured by the painted species as an RGBA GeoTIFF,
   ``chip_ortho`` (2048 px chips at a 1024 px stride) with the six star
   polygons as labels, the label chips as predictions (a third re-encoded
   with PNG filter types 3 and 4), ``assemble_ortho_predictions`` on the
   card bit-equal to the plain numpy assembly and equal to the burned
   labels on every observed pixel, the raster confusion matrix diagonal,
   and phase 9c's labelled polygons scored against the stars (raster and
   exact), with their stage times;
11. the last modules of the port, each with its view 0 held bit for bit
   against the plain versions at zero overflow: ``"11a"``, phase 8's 20
   views as a COLMAP text export (a SIMPLE_RADIAL sensor per suite sensor,
   k its k1) parsed by ``COLMAPCameraSet`` (poses within 1e-12), an
   ``images.txt`` of 1,000 images with 2,000-point rows parsed and timed,
   and seeded labels aggregated through the COLMAP set and through a
   ``CameraSet`` of the matrices and k1-only sensors written (view counts
   and fractions equal off the faces the two sets' rasters swap);
   ``"11b"``, ``create_undercanopy_survey`` of 10 stations of 2688 x 5376
   panoramas and 1344 px rig members, the rig cameras, ``LookUpSegmentor``
   and aggregation (every seen face's label recovered, most faces seen,
   two canopy classes; the survey's renders counted apart from the
   aggregation's launches); ``"11c"``, ``render_labels(make_composites=True,
   vis=True)`` for 4 views of phase 5's survey with PNG raw images (each
   composite equal to the plain one), ``visualize`` on the 999,698-face mesh
   with the HTML export and a screenshot at the caps its own census sizes
   (its value map the ortho kernel's pix2face, held against the float64
   oracle); ``"11d"``,
   ``rasterize_batch`` over phase 3's views equal to one
   ``rasterize_triangles`` a view, and ``determine_minimum_overlapping_images``
   on 10a's cameras with no ``raster_config`` picking 10a's picks at
   10a's census caps;
12. the eight example scripts of ``examples_torch/`` (the JAX package's
   ``examples/``, the notebooks' sizes), each ``main`` run on the card and
   again with ``device="cpu"``: every file and printed line of the two runs
   equal (aggregated fractions and points within a stated tolerance), each
   workflow's quantity at the bar of the JAX package's test of it, and the
   card's launches those of its views (one ``"12"`` line an example, with
   its card and CPU seconds).

The last two lines are the card's name and power limit, then
``{"ok": true, "device": {...}}``; the line before them is a JSON object
of per-kernel results, each with its time, its plain version's time, the
least time the card could take for the same work (``bound_ms``) and,
where one PyTorch call computes the same function, that call's time.
Without a CUDA device it exits nonzero before printing any result.  It
imports nothing of JAX or of the JAX package.

``--parent DIR`` names a checkout of another commit of this repository
(for instance ``git archive`` of the parent, unpacked under ``build/``):
the counts kernel of that tree and of this one (``"ab_counts"``), and
their front ends (``"ab_front"``: setup, binning, the census and the
whole fused chain of view 0, the setup's device time and host enqueue,
the two trees' counts equal) are then timed on the same
saved inputs in turns parent, change, change, parent, each turn a process
of its own started in its tree.  Every phase that demands its raster
launches also demands at least as many launches of the setup and the
binning kernels (a path that took a plain version on the card fails).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import csv
import dataclasses
import importlib
import io
import json
import logging
import math
import os
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np
import scipy.sparse
import torch

from geograypher_tpu_torch.cameras.colmap import COLMAPCameraSet
from geograypher_tpu_torch.cameras.core import CameraSet, project_points
from geograypher_tpu_torch.cameras.distortion import remap_image, remap_image_torch
from geograypher_tpu_torch.cameras.metashape import MetashapeCameraSet
from geograypher_tpu_torch.cameras.rig import create_rig_cameras_from_equirectangular
from geograypher_tpu_torch.cameras.segmentor_set import SegmentorCameraSet
from geograypher_tpu_torch.entrypoints.aggregate_images import aggregate_images
from geograypher_tpu_torch.entrypoints.annotation_image_selection import (
    determine_minimum_overlapping_images,
    greedy_set_cover,
    visibility_matrix,
)
from geograypher_tpu_torch.entrypoints.assemble_ortho_predictions import (
    assemble_ortho_predictions,
)
from geograypher_tpu_torch.entrypoints.chip_ortho import chip_ortho
from geograypher_tpu_torch.entrypoints.label_polygons import label_polygons
from geograypher_tpu_torch.entrypoints.multiview_detections import multiview_detections
from geograypher_tpu_torch.entrypoints.project_detections import project_detections
from geograypher_tpu_torch.entrypoints.render_height_masks import render_height_masks
from geograypher_tpu_torch.entrypoints.render_labels import render_labels
from geograypher_tpu_torch.entrypoints.visualize import visualize
from geograypher_tpu_torch.kernels import build
from geograypher_tpu_torch.meshes import chunked, sparse
from geograypher_tpu_torch.meshes.mesh import DEFAULT_RASTER_CONFIG, TexturedMesh
from geograypher_tpu_torch.ops import (
    binning,
    face_counts,
    face_sums,
    onehot,
    raster_tiles,
    subtile,
    tri_setup,
)
from geograypher_tpu_torch.ops.agg_tiled import project_image_class_counts_tiled
from geograypher_tpu_torch.ops.aggregate import (
    accumulate_view,
    finalize_aggregation,
    find_argmax_nonzero_value,
    init_aggregation,
    project_image_to_faces,
    render_texture,
)
from geograypher_tpu_torch.ops.rasterize import (
    RasterConfig,
    bin_all,
    bin_triangles,
    binned_face_lists,
    fused_view_class_counts,
    rasterize_batch,
    rasterize_setup,
    rasterize_triangles,
    setup_from_soa,
    setup_triangles,
    transform_to_camera,
    tri_to_soa,
)
from geograypher_tpu_torch.parallel import pipeline, planner, sharding
from geograypher_tpu_torch.parallel.planner import census_caps, census_config_of
from geograypher_tpu_torch.ops.raycast import clip_line_segments
from geograypher_tpu_torch.predictors.ortho import (
    assemble_tiled_predictions_plain,
    create_windows,
)
from geograypher_tpu_torch.predictors.segmentors import (
    ImageIDSegmentor,
    LookUpSegmentor,
    RegionDetectionSegmentor,
    TabularRectangleSegmentor,
)
from geograypher_tpu_torch.utils import crs as crs_utils
from geograypher_tpu_torch.utils.device import PinnedUpload
from geograypher_tpu_torch.utils.exact_geometry import polygon_intersection_area
from geograypher_tpu_torch.utils.example_data import (
    create_undercanopy_survey,
    local_to_ecef_frame,
    make_metashape_xml,
)
from geograypher_tpu_torch.utils.fixtures import (
    brute_force_pix2face,
    crowded_tile_triangles,
    gather_tri_verts,
    knife_edge_triangles,
    make_grid_mesh,
    nadir_camera,
    oblique_camera,
)
from geograypher_tpu_torch.utils import io as png_io
from geograypher_tpu_torch.utils.io import (
    PNG_ZLIB_LEVEL,
    read_image_or_numpy,
    write_image,
)
from geograypher_tpu_torch.utils.meshio import save_mesh
from geograypher_tpu_torch.utils.prediction_metrics import (
    cf_from_vector_vector,
    compute_comprehensive_metrics,
    compute_confusion_matrix_from_geospatial,
)
from geograypher_tpu_torch.utils.raster import Raster, read_geotiff, write_geotiff
from geograypher_tpu_torch.utils.vector import Polygon, VectorData, rasterize_polygons
from geograypher_tpu_torch.utils.visualization import composite_to_uint8, create_composite

N_CLASSES = 10
H, W = 2160, 3840
CAP_MARGIN = 1.25  # caps = ceil(census max x margin) + 8 slots
ORACLE_MIN_AGREE = 0.99  # f32 kernel vs the float64 oracle: knife-edge pixels
S_MIN_AGREE = 0.9999  # level S on vs off: only exact cross-group 1/z ties differ
LABEL_PATCH = 64  # side of the constant-class squares of the piecewise field
# the least time of a kernel's work on one H100 SXM (NVIDIA's data
# sheet): FP32 outside the tensor cores, HBM rate
FP32_FLOP_S = 67e12
HBM_BYTES_S = 3.35e12
# a candidate-pixel evaluation: 3 edge planes + the 1/z plane, each
# (a*x + b*y) + c, two multiplies and two adds
FLOP_PER_CAND_PIXEL = 16
# the replaced TPU kernels (function, file:line of its definition)
TPU_KERNELS = {
    "B1": "geograypher_tpu/ops/pallas_raster.py:524",
    "B2": "geograypher_tpu/ops/agg_tiled.py:1000",
    "B3": "geograypher_tpu/ops/agg_tiled.py:895",
    "B4": "geograypher_tpu/ops/agg_tiled.py:155",
    "B5": "geograypher_tpu/ops/subtile.py:352",
    "B6": "geograypher_tpu/ops/subtile.py:570",
}


# the front end's kernels took over XLA-fused code of the JAX package
SETUP_REPLACES = ("none: XLA-fused `setup_from_soa`, "
                  "geograypher_tpu/ops/rasterize.py:200")
BINNING_REPLACES = ("none: XLA key build and list cut around `jnp.sort` in "
                    "`bin_triangles`, geograypher_tpu/ops/rasterize.py:556")
# the setup's float operations a face (the plain version's, counted op by
# op: transform, reciprocal, projection, edges, area, depth plane, signs,
# box), and with the Brown-Conrady lens
SETUP_FLOP = 140
SETUP_FLOP_LENS = 215
# the setup's bytes a face: 9 float32 read; 12 plane floats, 4 int32 box
# bounds and one valid byte written
SETUP_BYTES = 9 * 4 + 12 * 4 + 4 * 4 + 1
# the setup's fixed-cost probe: faces of the middle of the bench mesh
SETUP_PROBE_FACES = 1024
# the front end's kernel-vs-plain rows by view name (``_front_vs_plain``)
FRONT_ROWS = {}
# the launch counts of the front end's kernels
FRONT = ("triangle_setup", "tile_binning")
# the front end's kernels as the profiler names them: the setup's, the
# binning's (the census runs the first three)
SETUP_KERNEL = "triangle_setup_kernel"
BINNING_KERNELS = ("Memset", "count_kernel", "scan_kernel", "scatter_kernel", "cut_kernel",
                   "cut_long_kernel")
# the binning probes: crowded tile lists (longer than a warp of the cut
# kernels sorts, ids spread over several bitmap windows) at 4K, and a view
# of the bench mesh on a grid past the count kernel's shared histogram
CROWDED_SCATTER = 200_000
BIG_GRID_SIDE = 8192
# csrc/tile_binning.cu's longest list a warp sorts (kMidSortMax) and the
# most tiles its count kernel counts in shared memory (kMaxSharedBins)
WARP_SORT_MAX = 512
SHARED_HISTOGRAM_BINS = 57344
# bytes written between profiled calls to evict the card's 50 MB L2
L2_FLUSH_BYTES = 128 << 20
# the most traces ``_profile`` takes until one is whole, and the host's
# wait after its timed window opens and before it closes
PROFILE_TRIES = 10
PROFILE_PAD_S = 0.01
# the device microseconds a launch under which ``_profile`` does not hold a
# kernel's launch count (the profiler's resolution is one microsecond)
PROFILE_SHORT_US = 2.0

# the host scan the one-hot kernel took over (both packages ran it in numpy)
ONEHOT_REPLACES = ("none: host numpy `_as_class_image`, "
                   "geograypher_tpu/meshes/mesh.py:1015")
# the per-face float sum of the means path: an XLA op in the JAX package
FACE_SUMS_REPLACES = ("none: XLA `segment_sum`, geograypher_tpu/ops/aggregate.py:76 "
                      "(the port's `index_add` before it)")
# phase 6: the planned mean against the streaming one (the same per-view
# means, summed in bucket order instead of view order)
PLANNED_MEAN_RTOL = 1e-6


class ImageSegmentor:
    """Prepared (H, W, C) images by camera index."""

    needs_image = False

    def __init__(self, images):
        self.images = images

    def segment_image(self, image, filename=None, image_scale: float = 1.0,
                      index=None, **kwargs):
        return self.images[index]


class LabelSegmentor:
    """In-memory integer label images by camera index, served as the
    float32 one-hot (H, W, C) stacks a segmentation model emits.  With
    ``names`` a view's labels are found by its image file's name instead,
    so that a subset of the cameras keeps each view's labels."""

    needs_image = False

    def __init__(self, labels: np.ndarray, num_classes: int, names=None):
        self.labels = labels
        self.num_classes = num_classes
        self._eye = np.eye(num_classes, dtype=np.float32)
        self._row = None if names is None else {n: i for i, n in enumerate(names)}

    def segment_image(self, image, filename=None, image_scale: float = 1.0,
                      index=None, **kwargs):
        if self._row is not None:
            index = self._row[Path(filename).name]
        return self._eye[self.labels[index]]


def _line(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _cuda_times(fn, runs=5):
    """Milliseconds of ``fn`` in ``runs`` timed calls (CUDA events, one
    untimed warm-up call first)."""
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def _cuda_ms(fn, runs=5):
    """Median milliseconds of ``fn`` over ``runs`` timed calls."""
    return statistics.median(_cuda_times(fn, runs))


def _ab_ms(fn_a, fn_b, runs=5):
    """Medians of two versions timed in turns a, b, b, a (``runs`` calls
    each turn), and the spread (max - min of the turn medians) of each."""
    ta1, tb1, tb2, ta2 = (statistics.median(_cuda_times(f, runs))
                          for f in (fn_a, fn_b, fn_b, fn_a))
    return ((ta1 + ta2) / 2, abs(ta1 - ta2)), ((tb1 + tb2) / 2, abs(tb1 - tb2))


def _profile(fn, runs=5, flush=False):
    """``fn`` run ``runs`` times under ``torch.profiler`` after a warm-up:
    (device busy share of the window, {kernel: device ms a call}, top
    10), or (None, {}) when no whole trace comes back.  A trace is whole
    when each kernel of it or of a trace of one call taken just before it
    is in both, launched ``runs`` times as often in it.  Kernels of under
    ``PROFILE_SHORT_US`` a launch are not held to that: the profiler reads
    whole microseconds and loses launches that read 0 (a one-microsecond
    memset is missing from many traces), which moves a sum by less than
    a microsecond a launch.  The profiler also drops the first launches
    of some traces on the card, so each trace starts with a warm-up step
    of one call whose events it discards, the host waits
    ``PROFILE_PAD_S`` after the timed window opens and before it closes,
    and a trace that is not whole is taken again, its one-call trace with
    it, up to ``PROFILE_TRIES`` times.  A kernel's ms a call is its time
    over the launches seen, times its launches in one call (a short
    kernel's, its time over ``runs``).  With ``flush`` each call is preceded by a fill
    of ``L2_FLUSH_BYTES`` (its kernel in the trace, its time in the busy
    share), so that each call reads its inputs from HBM, not from the L2
    the call before left them in."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    evict = (torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
             if flush else None)
    torch.cuda.synchronize()

    def call():
        if flush:
            evict.fill_(1)
        fn()

    def trace(calls):
        """(window ms, {kernel: (device us, launches)}) of ``calls`` calls."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            call()
            torch.cuda.synchronize()
            prof.step()
            time.sleep(PROFILE_PAD_S)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                call()
            end.record()
            end.synchronize()
            time.sleep(PROFILE_PAD_S)
            prof.step()
        seen = {}
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", 0) or 0
            if (us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA
                    and not ev.key.startswith("ProfilerStep")):
                name = ev.key[:60]
                us0, n0 = seen.get(name, (0.0, 0))
                seen[name] = (us0 + us, n0 + ev.count)
        return start.elapsed_time(end), seen

    for _ in range(PROFILE_TRIES):
        try:
            _, one = trace(1)
            wall_ms, seen = trace(runs)
        except RuntimeError:  # a card without profiler access: not measured
            return None, {}
        short = {k for trace_ in (one, seen) for k, (us, n) in trace_.items()
                 if us < PROFILE_SHORT_US * n}
        if one and all(k in one and k in seen and seen[k][1] == runs * one[k][1]
                       for k in seen.keys() - short | one.keys() - short):
            break
    else:
        return None, {}
    kernels = {k: us / 1e3 / (runs if k in short else n / one[k][1])
               for k, (us, n) in seen.items()}
    busy = sum(kernels.values()) * runs / wall_ms
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:10])
    return busy, top


def _bound(n_bytes, n_flop):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the FP32 operations over the FP32 peak."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_flop / FP32_FLOP_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _box_pixels(setup, faces=None):
    """The candidate-pixels a view's data needs: every valid face (of the
    mask ``faces``, when given) evaluated over the pixels of its own box,
    which ``setup.bbox`` holds clipped to the image."""
    py0, px0, py1, px1 = (setup.bbox[k].long() for k in range(4))
    keep = setup.valid if faces is None else setup.valid & faces
    return int(torch.where(keep, (py1 - py0 + 1) * (px1 - px0 + 1), 0).sum())


def _raster_bound(setup, planes, cand, counts, cfg, s_init=None, s_mask8=None,
                  h=H, w=W):
    """The tile raster's bound on this view: each face of the tile lists
    (those level S did not take, ``s_mask8``) over its own box; each
    input read once, the pix2face written once.  Also the candidate-pixels
    the kernel evaluates (every group candidate over the warp rectangles
    its cull box meets, ``raster_tiles.kernel_cand_pixels``) and what
    whole tiles would cost: every L0 tile's in-image pixels against its
    own, its L1 and L2 parents' and the global list's counts.  The image
    is ``h`` x ``w`` (default the 4K views')."""
    th, tw = cfg.tile_h, cfg.tile_w
    nty0, ntx0 = cfg.grids(h, w)[0]
    p1, p2 = raster_tiles._parents(cfg, h, w, planes.device)
    n = (counts[0].long() + counts[1].long()[p1] + counts[2].long()[p2]
         + counts[3].long())
    t = torch.arange(nty0 * ntx0, device=planes.device)
    pix = ((h - t // ntx0 * th).clamp(max=th) * (w - t % ntx0 * tw).clamp(max=tw))
    tile_pixels = int((n * pix).sum())
    cand_pixels = raster_tiles.kernel_cand_pixels(planes, setup.bbox, cand, counts,
                                                  cfg, h, w)
    listed = (None if s_mask8 is None
              else ~s_mask8.repeat_interleave(cfg.bin_block))
    need_pixels = _box_pixels(setup, listed)
    n_bytes = (planes.numel() * 4 + sum(c.numel() * 4 for c in cand)
               + sum(c.numel() * 4 for c in counts) + h * w * 4
               + (0 if s_init is None else 2 * h * w * 4))
    return (_bound(n_bytes, FLOP_PER_CAND_PIXEL * need_pixels), need_pixels,
            cand_pixels, tile_pixels)


def _s_raster_bound(setup, su, cfg):
    """The sub-tile raster's bound: each face level S took over its own
    box; the CSR lists (``bin_subtiles``, built here untimed) and the S
    units' plane rows read once, both (H, W) planes written once.  Also
    the candidate-pixels the kernel evaluates (each S face over its
    domain, ``subtile.s_face_domains``) and what every S face slot over
    its sub-tiles' pixels would cost."""
    sb = subtile.bin_subtiles(setup, cfg, H, W)
    sh, sw = cfg.subtile
    _, nsx = subtile.subtile_grid(cfg, H, W)
    sub = sb.sub_ids.long()
    pix = ((H - sub // nsx * sh).clamp(max=sh) * (W - sub % nsx * sw).clamp(max=sw))
    subtile_pixels = int((sb.sub_count.long() * cfg.s_block * pix).sum())
    dom = subtile.s_face_domains(su, setup, cfg, H, W)
    cand_pixels = int(((dom[:, 2] - dom[:, 0] + 1).clamp(min=0)
                       * (dom[:, 3] - dom[:, 1] + 1).clamp(min=0)).sum())
    need_pixels = _box_pixels(setup, sb.s_mask8.repeat_interleave(cfg.bin_block))
    n_units = int(torch.unique(sb.units).numel())
    n_bytes = (4 * (sb.units.numel() + 3 * sb.sub_ids.numel())
               + n_units * cfg.s_block * 48 + 2 * H * W * 4)
    return (_bound(n_bytes, FLOP_PER_CAND_PIXEL * need_pixels), need_pixels,
            cand_pixels, subtile_pixels, sb)


def _counts_bound(n_faces):
    """The counts kernel's bound: pix2face and class image read, the
    (F, C) int32 counts written."""
    return _bound(2 * H * W * 4 + n_faces * N_CLASSES * 4, 0)


def _counts_library_ms(p2f, cls, n_faces):
    """One ``torch.bincount`` over the flat (face, class) key, background
    shifted into the first C bins; the port never calls it."""
    key = ((p2f.long() + 1) * N_CLASSES + cls.long()).reshape(-1)
    return _cuda_ms(lambda: torch.bincount(key, minlength=(n_faces + 1) * N_CLASSES),
                    runs=20)


def _patch_adds(p2f, cls, n_faces):
    """(labelled mesh pixels, atomic adds the counts kernel issues): one
    add per distinct (face, class) key of each 8 x 4 pixel patch."""
    key = torch.where((p2f >= 0) & (p2f < n_faces) & (cls >= 0) & (cls < N_CLASSES),
                      p2f.long() * N_CLASSES + cls.long(), -1)
    key = torch.nn.functional.pad(
        key, (0, -key.shape[1] % 8, 0, -key.shape[0] % 4), value=-1)
    rows = key.reshape(key.shape[0] // 4, 4, key.shape[1] // 8, 8)
    rows = rows.permute(0, 2, 1, 3).reshape(-1, 32).sort(dim=1).values
    first = (rows[:, 1:] != rows[:, :-1]) & (rows[:, 1:] >= 0)
    return int((key >= 0).sum()), int(first.sum() + (rows[:, 0] >= 0).sum())


def _device_ms(fn, runs=10):
    """Device milliseconds of all kernels of one ``fn()`` call (profiler;
    None when the trace holds no device time)."""
    _, kernels = _profile(fn, runs)
    return sum(kernels.values()) if kernels else None


def _device_by_name(fn, names, runs=5):
    """Device milliseconds a call of the kernels whose profiler names hold
    each of ``names`` ({name: ms}, None where no kernel of the trace holds
    the name; None when no whole trace comes back, ``_profile``), over
    ``runs`` calls of ``fn``, the L2 evicted before each."""
    _, kernels = _profile(fn, runs, flush=True)
    if not kernels:
        return None
    return {n: (sum(ms for k, ms in kernels.items() if n in k)
                if any(n in k for k in kernels) else None) for n in names}


def _sum_or_none(values):
    """The sum of ``values``, or None if any is None."""
    values = list(values)
    return None if None in values else sum(values)


def _binning_outputs(binned):
    return (binned.cand + binned.counts + (binned.face_cand or ())
            + (binned.face_counts or ()) + (binned.overflow,))


def _counts_vs_plain(name, p2f, cls, n_faces, prefix="counts_", device_time=False):
    """The counts kernel against its plain version on one label field,
    bit for bit: the times of the wrapper call, the plain version and the
    library call (medians of 20), the adds the field leaves and, when
    asked, the device time of the wrapper's kernels (zero fill and counts
    kernel)."""
    cnt = face_counts.face_class_counts(p2f, cls, n_faces, N_CLASSES)
    cnt_plain = face_counts.face_class_counts_plain(p2f, cls, n_faces, N_CLASSES)
    if not torch.equal(cnt, cnt_plain):
        raise RuntimeError(f"counts kernel vs plain on {name} ({prefix}): max |diff| "
                           f"{int((cnt - cnt_plain).abs().max())}")
    pixels, adds = _patch_adds(p2f, cls, n_faces)
    row = {
        prefix + "max_abs_err": int((cnt - cnt_plain).abs().max()),
        prefix + "ms": _cuda_ms(lambda: face_counts.face_class_counts(
            p2f, cls, n_faces, N_CLASSES), runs=20),
        prefix + "plain_ms": _cuda_ms(lambda: face_counts.face_class_counts_plain(
            p2f, cls, n_faces, N_CLASSES)),
        prefix + "library_ms": _counts_library_ms(p2f, cls, n_faces),
        prefix + "pixels": pixels, prefix + "adds": adds,
    }
    if device_time:
        row[prefix + "device_ms"] = _device_ms(
            lambda: face_counts.face_class_counts(p2f, cls, n_faces, N_CLASSES))
    return row


def _knife_edge(a, b):
    """(agreement, face-vs-background disagreements) of two pix2face
    maps; the oracle contract wants >= 99% agreement and every
    disagreement a swap between two faces."""
    diff = a != b
    bg = diff & ((a < 0) | (b < 0))
    return 1.0 - diff.float().mean().item(), int(bg.sum())


def _suite_cameras(focals=(2000.0, 2600.0), n_views=8):
    """The bench's mixed suite: even views nadir with seeded jitter, odd
    views oblique at 15-35 deg off nadir, alternating focal lengths."""
    rng = np.random.default_rng(0)
    c2ws = []
    for k in range(n_views):
        focal = focals[k % len(focals)]
        if k % 2 == 0:
            c2w = nadir_camera(4.0, focal, W)
            c2w[0, 3] += rng.uniform(-0.3, 0.3)
            c2w[1, 3] += rng.uniform(-0.3, 0.3)
            c2w[2, 3] += rng.uniform(0.0, 0.3)
        else:
            c2w = oblique_camera(
                4.0, focal, W,
                pitch_deg=float(rng.uniform(15.0, 35.0)),
                azimuth_deg=float(360.0 * k / n_views),
            )
        c2ws.append(c2w)
    return c2ws


def _bench_scene(dev, mesh_n=708):
    """The bench grid mesh (999,698 faces at ``mesh_n=708``), spatially
    sorted, on ``dev``, and the suite's 8 cameras: two lens models
    (pinhole, Brown-Conrady), each at the two focals.  Returns (verts,
    faces, mesh, c2ws, sensors, sensor_ids, cams)."""
    verts, faces = make_grid_mesh(
        n=mesh_n, size=4.0, z_fn=lambda x, y: 0.1 * np.sin(3 * x) * np.cos(3 * y)
    )
    mesh = TexturedMesh((verts, faces), raster_config=RasterConfig(), device=dev)
    mesh.spatial_sort_faces()
    c2ws = _suite_cameras()
    dist = {"k1": 0.02, "k2": -0.01, "p1": 1e-3}
    sensors = {
        2 * d + j: {"f": fl, "cx": 0.0, "cy": 0.0, "image_width": W,
                    "image_height": H,
                    **({"distortion_params": dist} if d else {})}
        for d in (0, 1) for j, fl in enumerate((2000.0, 2600.0))
    }
    sensor_ids = [2 * (k >= 6) + (k % 2) for k in range(len(c2ws))]
    cams = CameraSet(c2ws, sensors, sensor_IDs=sensor_ids)
    return verts, faces, mesh, c2ws, sensors, sensor_ids, cams


def _census_caps(setups, cfg):
    """Per-level exact census max over ``setups`` and the caps it sizes
    (with level S on, of the L0..L3 lists after its diversion)."""
    census = torch.stack([
        bin_triangles(s, cfg, H, W, return_census=True,
                      exclude_blocks=None if cfg.subtile is None
                      else subtile.subtile_mask8(s, cfg))
        for s in setups
    ]).amax(0).tolist()
    return census, tuple(int(math.ceil(m * CAP_MARGIN)) + 8 for m in census)


def _kernel_vs_plain(name, setup, cfg, n_faces, cls, cls_piecewise=None):
    """Both kernels against their plain versions on one view, bit for
    bit, and the median times of all four; the counts kernel also on the
    piecewise-constant label field when one is given."""
    binned = bin_triangles(setup, cfg, H, W)
    if int(binned.overflow):
        raise RuntimeError(f"{name}: caps {cfg.caps} overflow ({int(binned.overflow)})")
    cand, counts = binned_face_lists(binned, cfg)
    planes, bbox = setup.planes.contiguous(), setup.bbox
    p2f = raster_tiles.raster_tiles(planes, bbox, cand, counts, cfg, H, W)
    p2f_plain = raster_tiles.raster_tiles_plain(planes, cand, counts, cfg, H, W)
    torch.cuda.synchronize()
    if not torch.equal(p2f, p2f_plain):
        agree, bg = _knife_edge(p2f, p2f_plain)
        raise RuntimeError(
            f"raster kernel vs plain on {name}: {int((p2f != p2f_plain).sum())} "
            f"pixels differ (agreement {agree:.6f}, {bg} face-vs-background)"
        )
    counts_row = _counts_vs_plain(name, p2f, cls, n_faces, device_time=True)
    if cls_piecewise is not None:
        counts_row.update(_counts_vs_plain(name, p2f, cls_piecewise, n_faces,
                                           "counts_piecewise_", device_time=True))
    (raster_bound_ms, raster_bound_by), need_pixels, cand_pixels, tile_pixels = (
        _raster_bound(setup, planes, cand, counts, cfg))
    counts_bound_ms, counts_bound_by = _counts_bound(n_faces)
    row = dict(
        view=name, bin_block=cfg.bin_block,
        census=bin_triangles(setup, cfg, H, W, return_census=True).tolist(),
        caps=list(cfg.caps),
        coverage=round((p2f >= 0).float().mean().item(), 6),
        list_entries=[int(c.sum()) for c in counts],
        raster_max_abs_err=int((p2f - p2f_plain).abs().max()),
        raster_ms=_cuda_ms(lambda: raster_tiles.raster_tiles(
            planes, bbox, cand, counts, cfg, H, W)),
        raster_plain_ms=_cuda_ms(lambda: raster_tiles.raster_tiles_plain(
            planes, cand, counts, cfg, H, W), runs=3),
        **counts_row,
        raster_cand_pixels=cand_pixels, raster_tile_cand_pixels=tile_pixels,
        raster_need_pixels=need_pixels,
        raster_bound_ms=raster_bound_ms, raster_bound_by=raster_bound_by,
        counts_bound_ms=counts_bound_ms, counts_bound_by=counts_bound_by,
    )
    _line(2, **row)
    return row


def _s_kernels_vs_plain(name, setup, cfg, n_faces, cls):
    """Level S on one view: the sub-tile raster, the S-seeded tile raster
    and the counts kernel against their plain versions, bit for bit, and
    the median times of all six."""
    binned, su = bin_all(setup, cfg, H, W)
    if int(binned.overflow):
        raise RuntimeError(f"{name}: S caps {cfg.caps} overflow ({int(binned.overflow)})")
    cand, counts = binned_face_lists(binned, cfg)
    planes, bbox = setup.planes.contiguous(), setup.bbox
    (s_bound_ms, s_bound_by), s_need_pixels, s_cand_pixels, s_sub_pixels, sb = (
        _s_raster_bound(setup, su, cfg))
    s_w, s_id = subtile.s_raster(su, setup, cfg, H, W)
    s_w_p, s_id_p = subtile.s_raster_plain(sb, planes, cfg, H, W)
    torch.cuda.synchronize()
    if not (torch.equal(s_w, s_w_p) and torch.equal(s_id, s_id_p)):
        raise RuntimeError(
            f"s_raster vs plain on {name}: {int((s_id != s_id_p).sum())} ids and "
            f"{int((s_w != s_w_p).sum())} depths differ")
    s_init = (s_w, s_id)
    p2f = raster_tiles.raster_tiles(planes, bbox, cand, counts, cfg, H, W,
                                    s_init=s_init)
    p2f_plain = raster_tiles.raster_tiles_plain(planes, cand, counts, cfg, H, W,
                                                s_init=s_init)
    torch.cuda.synchronize()
    if not torch.equal(p2f, p2f_plain):
        agree, bg = _knife_edge(p2f, p2f_plain)
        raise RuntimeError(
            f"S-seeded raster vs plain on {name}: {int((p2f != p2f_plain).sum())} "
            f"pixels differ (agreement {agree:.6f}, {bg} face-vs-background)")
    counts_row = _counts_vs_plain(name + " (level S)", p2f, cls, n_faces)
    (r_bound_ms, r_bound_by), r_need_pixels, r_cand_pixels, r_tile_pixels = (
        _raster_bound(setup, planes, cand, counts, cfg, s_init, su.s_mask8))
    row = dict(
        view=name, bin_block=cfg.bin_block, subtile=list(cfg.subtile),
        caps=list(cfg.caps), list_entries=[int(c.sum()) for c in counts],
        s_pairs=int(subtile.subtile_pairs(su)), s_occupied=int(sb.sub_ids.numel()),
        s_diverted_blocks=int(su.s_mask8.sum()),
        s_covered=round((s_id >= 0).float().mean().item(), 6),
        coverage=round((p2f >= 0).float().mean().item(), 6),
        s_raster_max_abs_err=max(int((s_id - s_id_p).abs().max()),
                                 int((s_w != s_w_p).sum())),
        raster_max_abs_err=int((p2f - p2f_plain).abs().max()),
        s_raster_ms=_cuda_ms(lambda: subtile.s_raster(su, setup, cfg, H, W)),
        s_raster_plain_ms=_cuda_ms(
            lambda: subtile.s_raster_plain(sb, planes, cfg, H, W)),
        raster_ms=_cuda_ms(lambda: raster_tiles.raster_tiles(
            planes, bbox, cand, counts, cfg, H, W, s_init=s_init)),
        raster_plain_ms=_cuda_ms(lambda: raster_tiles.raster_tiles_plain(
            planes, cand, counts, cfg, H, W, s_init=s_init), runs=3),
        **counts_row,
        s_cand_pixels=s_cand_pixels, s_subtile_cand_pixels=s_sub_pixels,
        raster_cand_pixels=r_cand_pixels, raster_tile_cand_pixels=r_tile_pixels,
        s_need_pixels=s_need_pixels, raster_need_pixels=r_need_pixels,
        s_raster_bound_ms=s_bound_ms, s_raster_bound_by=s_bound_by,
        raster_bound_ms=r_bound_ms, raster_bound_by=r_bound_by,
    )
    _line("2s", **row)
    return row


def _knife_edge_probe(cls, dev):
    """Phase 2's knife-edge probe at 4K: ``knife_edge_triangles`` (vertices
    on and within 1e-4 px of pixel centres, axis-aligned edges through
    them, slivers, edges longer than 2^18 px), both rasters bit-equal to
    their plain versions at the main configuration (``bin_block=1``) and
    at the level-S configuration."""
    tri = torch.as_tensor(knife_edge_triangles(W, H), device=dev)
    setup = setup_triangles(tri, torch.tensor(1.0, device=dev), W, H)
    n = tri.shape[0]
    long_edges = int((setup.valid & (setup.planes[:, [0, 1, 3, 4, 6, 7]].abs()
                                     .amax(dim=1) > 2.0**18)).sum())
    if long_edges == 0:
        raise RuntimeError("knife-edge probe: no valid face with an edge over 2^18 px")
    cfg = RasterConfig()
    cfg = dataclasses.replace(cfg, caps=_census_caps([setup], cfg)[1])
    inputs = (tri_to_soa(tri), torch.eye(4, device=dev), torch.tensor(1.0, device=dev))
    _front_vs_plain("knife_edge", *inputs, cfg)
    _kernel_vs_plain("knife_edge", setup, cfg, n, cls)
    base = RasterConfig(bin_block=8, l0_window=(5, 2))
    cfg_s = dataclasses.replace(base, subtile=(8, 16), s_window=(3, 2), s_block=4)
    cfg_s = dataclasses.replace(cfg_s, caps=_census_caps([setup], cfg_s)[1])
    _front_vs_plain("knife_edge_s", *inputs, cfg_s)
    _s_kernels_vs_plain("knife_edge", setup, cfg_s, n, cls)
    _line("knife_edge", faces=n, valid=int(setup.valid.sum()),
          long_edge_faces=long_edges,
          exempt_faces=int((raster_tiles.cull_rule(setup.planes, H, W)
                            == raster_tiles.CULL_EXEMPT).sum()),
          raster_equal=True, s_raster_equal=True, s_carry_equal=True)


def _binning_probes(soa, cfg, dev):
    """Phase 2's binning probes, each at census-sized caps and at half of
    the census (lists past their caps), bit-equal to the plain version
    (``_front_vs_plain``): ``crowded_tile_triangles`` at 4K, whose L0 and
    global lists are longer than a warp sorts (``WARP_SORT_MAX``), their ids
    spread over several bitmap windows; and the bench mesh seen nadir on a
    ``BIG_GRID_SIDE``^2 grid, more tiles than the count kernel's shared
    histogram holds (``SHARED_HISTOGRAM_BINS``)."""
    tri = torch.as_tensor(crowded_tile_triangles(W, H, n_scatter=CROWDED_SCATTER),
                          device=dev)
    crowded = (tri_to_soa(tri), torch.eye(4, device=dev), torch.tensor(1.0, device=dev),
               RasterConfig(), H, W)
    side = BIG_GRID_SIDE
    f_big = 2000.0 * side / W
    big = (soa, *_probe_inputs(soa, nadir_camera(4.0, f_big, side), f_big), cfg, side, side)
    for name, (rows, w2c, f, base, h, w) in (("crowded", crowded), ("grid_8192", big)):
        setup = setup_from_soa(rows, w2c, f, w, h, base.znear)
        census = bin_triangles(setup, base, h, w, return_census=True).tolist()
        tiles = sum(a * b for a, b in base.grids(h, w)) + 1
        if name == "crowded" and min(census[0], census[3]) <= WARP_SORT_MAX:
            raise RuntimeError(f"crowded probe census {census}: no list past "
                               f"{WARP_SORT_MAX}")
        if name == "grid_8192" and tiles <= SHARED_HISTOGRAM_BINS:
            raise RuntimeError(f"grid probe: {tiles} tiles fit the shared histogram")
        for tag, caps in (("", [int(math.ceil(c * CAP_MARGIN)) + 8 for c in census]),
                          ("_half", [max(1, c // 2) for c in census])):
            row = _front_vs_plain(name + tag, rows, w2c, f,
                                  dataclasses.replace(base, caps=tuple(caps)), h=h, w=w)
            _line("binning_probe", view=name + tag, tiles=tiles, census=census,
                  caps=caps, overflow=row["overflow"], lists_equal=True, runs_equal=True)


def _setup_equal(a, b):
    """Two setups equal bit for bit (planes as their int32 words)."""
    return (torch.equal(a.planes.view(torch.int32), b.planes.view(torch.int32))
            and torch.equal(a.bbox, b.bbox) and torch.equal(a.valid, b.valid))


def _front_vs_plain(name, soa, w2c, f, cfg, dist=None, h=H, w=W):
    """Both front-end kernels against their plain versions on one view,
    bit for bit: the setup (planes, boxes, validity), then on the plain
    setup the binning's census and its lists, counts, overflow and face
    lists at ``cfg`` (with level S on, after its exclusion), and a second
    binning run equal to the first.  Times (CUDA events, medians) of the
    wrappers and the plain versions (binning with its face-list
    expansion), the device time of each kernel by name (profiler, the L2
    evicted before each call), and the bounds: each input read once, each
    output written once.  The row goes to ``FRONT_ROWS[name]`` and its line."""
    got = setup_from_soa(soa, w2c, f, w, h, cfg.znear, distortion=dist)
    want = tri_setup.setup_from_soa_plain(soa, w2c, f, w, h, cfg.znear, dist)
    torch.cuda.synchronize()
    if not _setup_equal(got, want):
        bad = ((got.planes.view(torch.int32) != want.planes.view(torch.int32)).any(1)
               | (got.bbox != want.bbox).any(0) | (got.valid != want.valid))
        i = int(torch.nonzero(bad)[0])
        raise RuntimeError(
            f"setup kernel vs plain on {name}: {int(bad.sum())} faces differ; face {i}: "
            f"{got.planes[i].tolist()} {got.bbox[:, i].tolist()} {bool(got.valid[i])} vs "
            f"{want.planes[i].tolist()} {want.bbox[:, i].tolist()} {bool(want.valid[i])}")
    exclude = None if cfg.subtile is None else subtile.subtile_mask8(want, cfg)
    census = bin_triangles(want, cfg, h, w, return_census=True, exclude_blocks=exclude)
    census_plain = binning.bin_triangles_plain(want, cfg, h, w, True, exclude)
    binned = bin_triangles(want, cfg, h, w, exclude_blocks=exclude)
    plain = binning.bin_triangles_plain(want, cfg, h, w, False, exclude)
    face_lists = binned_face_lists(binned, cfg)
    face_lists_plain = binned_face_lists(plain, cfg)
    torch.cuda.synchronize()
    same = (torch.equal(census, census_plain) and torch.equal(binned.overflow, plain.overflow)
            and all(torch.equal(a, b) for a, b in zip(
                binned.cand + binned.counts + face_lists[0] + face_lists[1],
                plain.cand + plain.counts + face_lists_plain[0] + face_lists_plain[1])))
    if not same:
        raise RuntimeError(
            f"binning kernels vs plain on {name}: census {census.tolist()} vs "
            f"{census_plain.tolist()}, overflow {int(binned.overflow)} vs "
            f"{int(plain.overflow)}, levels differing "
            f"{[l for l in range(4) if not torch.equal(binned.cand[l], plain.cand[l])]}")
    again = bin_triangles(want, cfg, h, w, exclude_blocks=exclude)
    census_again = bin_triangles(want, cfg, h, w, return_census=True, exclude_blocks=exclude)
    torch.cuda.synchronize()
    if not (torch.equal(census, census_again) and all(
            torch.equal(a, b) for a, b in zip(_binning_outputs(binned),
                                              _binning_outputs(again)))):
        raise RuntimeError(f"binning kernels on {name}: two runs differ")
    by_name = _device_by_name(
        lambda: (setup_from_soa(soa, w2c, f, w, h, cfg.znear, distortion=dist),
                 bin_triangles(want, cfg, h, w, exclude_blocks=exclude)),
        (SETUP_KERNEL,) + BINNING_KERNELS)
    census_by_name = _device_by_name(
        lambda: bin_triangles(want, cfg, h, w, return_census=True, exclude_blocks=exclude),
        BINNING_KERNELS[:3])
    n = soa.shape[1]
    setup_bound_ms, setup_bound_by = _bound(
        SETUP_BYTES * n, (SETUP_FLOP if dist is None else SETUP_FLOP_LENS) * n)
    list_bytes = sum(4 * (c.numel() + k.numel()) for c, k in zip(binned.cand, binned.counts))
    if cfg.bin_block > 1:
        list_bytes += sum(4 * (c.numel() + k.numel()) for c, k in zip(*face_lists))
    in_bytes = 17 * n + (0 if exclude is None else exclude.numel())
    binning_bound_ms, binning_bound_by = _bound(in_bytes + list_bytes + 8, 0)
    census_bound_ms, _ = _bound(in_bytes + 32, 0)
    row = dict(
        view=name, faces=n, bin_block=cfg.bin_block, l0_window=cfg.l0_window,
        subtile=cfg.subtile, distorted=dist is not None, image=[h, w],
        valid=int(want.valid.sum()), census=census.tolist(), caps=list(cfg.caps),
        overflow=int(binned.overflow), runs_equal=True,
        setup_max_abs_err=float((got.planes - want.planes).abs().nan_to_num(0).max()),
        binning_max_abs_err=0,
        setup_ms=_cuda_ms(lambda: setup_from_soa(soa, w2c, f, w, h, cfg.znear,
                                                 distortion=dist), runs=20),
        setup_plain_ms=_cuda_ms(lambda: tri_setup.setup_from_soa_plain(
            soa, w2c, f, w, h, cfg.znear, dist)),
        setup_bound_ms=setup_bound_ms, setup_bound_by=setup_bound_by,
        binning_ms=_cuda_ms(lambda: binned_face_lists(bin_triangles(
            want, cfg, h, w, exclude_blocks=exclude), cfg), runs=20),
        binning_plain_ms=_cuda_ms(lambda: binned_face_lists(binning.bin_triangles_plain(
            want, cfg, h, w, False, exclude), cfg)),
        binning_bound_ms=binning_bound_ms, binning_bound_by=binning_bound_by,
        census_ms=_cuda_ms(lambda: bin_triangles(want, cfg, h, w, return_census=True,
                                                 exclude_blocks=exclude), runs=20),
        census_plain_ms=_cuda_ms(lambda: binning.bin_triangles_plain(
            want, cfg, h, w, True, exclude)),
        census_bound_ms=census_bound_ms,
        # device ms a call by kernel name (None: no whole trace, or no kernel
        # of that name in it)
        setup_device_ms=by_name and by_name[SETUP_KERNEL],
        binning_device_ms=by_name and _sum_or_none(by_name[k] for k in BINNING_KERNELS),
        binning_device_kernels=by_name and {k: by_name[k] for k in BINNING_KERNELS},
        census_device_ms=census_by_name and _sum_or_none(census_by_name.values()),
        census_device_kernels=census_by_name,
    )
    FRONT_ROWS[name] = row
    _line("front", **row)
    return row


def _setup_host_us(rows, w2c, f, znear, calls=1000):
    """Host microseconds one ``tri_setup.triangle_setup`` call on (rows,
    w2c, f) takes to enqueue, and its parts alone: the checks, the one
    allocation (its views, within it, also alone), the stream lookup, the
    ctypes call of the C entry point on prepared arguments, and the rest
    (the total less the allocation, the lookup and the call).  Each the
    median of 5 runs of ``calls`` calls, no synchronise inside a run."""
    dev, n = rows.device, rows.shape[1]
    lib = build.load()

    def per_call(fn, repeats=5):
        fn()
        times = []
        for _ in range(repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter_ns()
            for _ in range(calls):
                fn()
            times.append((time.perf_counter_ns() - t0) / calls / 1e3)
        torch.cuda.synchronize()
        return sorted(times)[repeats // 2]

    scalars = tri_setup._checked(rows, w2c, f, None)
    buf, _ = tri_setup._outputs(n, dev)
    args = (rows.data_ptr(), n, w2c.data_ptr(), *scalars, znear, W, H, buf.data_ptr(),
            dev.index, build.raw_stream(dev.index))
    out = {
        "total": per_call(lambda: tri_setup.triangle_setup(rows, w2c, f, W, H, znear)),
        "checks": per_call(lambda: tri_setup._checked(rows, w2c, f, None)),
        "allocations": per_call(lambda: tri_setup._outputs(n, dev)),
        "views": per_call(lambda: tri_setup._views(buf, n)),
        "stream": per_call(lambda: build.raw_stream(dev.index)),
        "ctypes_call": per_call(lambda: lib.gg_triangle_setup(*args)),
    }
    out["rest"] = out["total"] - (out["allocations"] + out["stream"] + out["ctypes_call"])
    return {k: round(v, 3) for k, v in out.items()}


def _setup_probe(soa, c2w, f, cfg):
    """The setup's fixed cost, on ``SETUP_PROBE_FACES`` faces of the middle
    of the mesh under a 4K probe camera: the kernel bit-equal to its plain
    version and two runs equal; the wrapper's ms (CUDA events, median of
    20), the kernel's device ms by name (the L2 evicted before each of 5
    calls) and the plain version's ms (the ``"setup_probe"`` line); and
    the host's microseconds to enqueue one wrapper call, split into its
    parts (the ``"setup_host_us"`` line, ``_setup_host_us``)."""
    mid = soa.shape[1] // 2
    rows = soa[:, mid:mid + SETUP_PROBE_FACES].contiguous()
    w2c, f_t = _probe_inputs(rows, c2w, f)

    def call():
        return setup_from_soa(rows, w2c, f_t, W, H, cfg.znear)

    got, again = call(), call()
    want = tri_setup.setup_from_soa_plain(rows, w2c, f_t, W, H, cfg.znear)
    torch.cuda.synchronize()
    if not (_setup_equal(got, want) and _setup_equal(again, got)):
        raise RuntimeError("setup kernel on the fixed-cost probe: not equal to the plain "
                           "version, or two runs differ")
    host = _setup_host_us(rows, w2c, f_t, cfg.znear)
    _line("setup_host_us", faces=SETUP_PROBE_FACES, calls=1000, **host)
    by_name = _device_by_name(call, (SETUP_KERNEL,))
    bound_ms, bound_by = _bound(SETUP_BYTES * SETUP_PROBE_FACES,
                                SETUP_FLOP * SETUP_PROBE_FACES)
    _line("setup_probe", faces=SETUP_PROBE_FACES, valid=int(want.valid.sum()),
          equal_to_plain=True, runs_equal=True, setup_ms=_cuda_ms(call, runs=20),
          setup_device_ms=by_name and by_name[SETUP_KERNEL],
          setup_plain_ms=_cuda_ms(lambda: tri_setup.setup_from_soa_plain(
              rows, w2c, f_t, W, H, cfg.znear)),
          setup_bound_ms=bound_ms, setup_bound_by=bound_by, host_us=host["total"])


def _piecewise_labels(rng, h, w):
    """(h, w) int32 classes, constant over LABEL_PATCH-pixel squares."""
    squares = rng.integers(0, N_CLASSES, (-(-h // LABEL_PATCH), -(-w // LABEL_PATCH)),
                           dtype=np.int32)
    return np.ascontiguousarray(
        np.kron(squares, np.ones((LABEL_PATCH, LABEL_PATCH), np.int32))[:h, :w])


def _onehot_probe_images(onehot32):
    """(name, image, is an exact one-hot stack) probes made from one
    float32 one-hot image: itself, in float64, with a block of unlabeled
    (all-NaN) rows, and three that the scan must refuse."""
    h, w, c = onehot32.shape
    yield "float32", onehot32, True
    yield "float64", onehot32.astype(np.float64), True
    nan_rows = onehot32.copy()
    nan_rows[h // 20: h // 20 + max(1, h // 10)] = np.nan
    yield "nan_rows", nan_rows, True
    for name, row in (("soft_value", [0.0, 0.5] + [0.0] * (c - 2)),
                      ("two_ones", [1.0, 1.0] + [0.0] * (c - 2)),
                      ("nan_beside_zeros", [np.nan] + [0.0] * (c - 1))):
        bad = onehot32.copy()
        bad[h // 2, w // 2] = row
        yield name, bad, False


def _check_onehot(name, image, accept, dev):
    """The one-hot scan on ``dev`` against its plain version (class image
    bit for bit, the same violations) and against the numpy scan; returns
    the image on ``dev`` and the largest difference to the plain version."""
    img = torch.as_tensor(image).to(dev)
    cls, violations = onehot.onehot_to_class(img)
    cls_plain, violations_plain = onehot.onehot_to_class_plain(img)
    if not torch.equal(cls, cls_plain) or int(violations) != int(violations_plain):
        raise RuntimeError(
            f"one-hot kernel vs plain on {name}: {int((cls != cls_plain).sum())} "
            f"pixels differ, violations {int(violations)} vs {int(violations_plain)}")
    reference = TexturedMesh._as_class_image(image)
    if (int(violations) == 0) != accept or (reference is not None) != accept:
        raise RuntimeError(f"one-hot scan of {name}: violations {int(violations)}, "
                           f"numpy {'accepts' if reference is not None else 'refuses'}")
    if accept and not np.array_equal(cls.cpu().numpy(), reference):
        raise RuntimeError(f"one-hot scan of {name} differs from the numpy scan")
    return img, int((cls - cls_plain).abs().max())


def _check_refused_takes_means(name, mesh, cams, image):
    """``project_images`` on view 0 serving a refused image: one scan, no
    counts-kernel launch, and the per-channel means of the pinhole
    pix2face (sums of halves and ones: exact in float32)."""
    one = SegmentorCameraSet(cams.get_subset_cameras([0]), ImageSegmentor([image]))
    scans, counted = onehot.launches, face_counts.launches
    (sums, counts), = list(mesh.project_images(one))
    on_card = mesh.device.type == "cuda"
    if (onehot.launches - scans, face_counts.launches - counted) != (int(on_card), 0):
        raise RuntimeError(f"refused image {name}: {onehot.launches - scans} scans, "
                           f"{face_counts.launches - counted} counts launches")
    p2f, _ = mesh._rasterize_view(cams, 0, 1.0, None, mesh.raster_config)
    want_sums, want_counts = project_image_to_faces(
        p2f, torch.as_tensor(image).to(mesh.device), mesh.n_faces)
    if not (torch.equal(sums, want_sums) and torch.equal(counts, want_counts)):
        raise RuntimeError(f"refused image {name}: not the means path's output")


def _onehot_probes(mesh, cams, onehot32, dev):
    """Phase 2's one-hot probes at 4K; returns the kernel's row."""
    row = {"max_abs_err": 0}
    for name, image, accept in _onehot_probe_images(onehot32):
        img, err = _check_onehot(name, image, accept, dev)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if name in ("float32", "float64"):
            n_bytes = img.numel() * img.element_size() + img.shape[0] * img.shape[1] * 4
            row[name] = dict(
                ms=_cuda_ms(lambda: onehot.onehot_to_class(img)),
                plain_ms=_cuda_ms(lambda: onehot.onehot_to_class_plain(img)),
                bound_ms=_bound(n_bytes, 0)[0],
                # device ms a call by kernel name on view 0's image (profiler)
                device_kernels=_profile(lambda: onehot.onehot_to_class(img))[1] or None)
            row[name]["device_ms"] = (row[name]["device_kernels"]
                                      and sum(row[name]["device_kernels"].values()))
        del img
        if not accept:
            _check_refused_takes_means(name, mesh, cams, image)
    _line("2o", shape=list(onehot32.shape), kernel_equals_plain=True,
          accepted_equal_numpy=True, refused_take_means_path=True, **row)
    return row


def _label_stage_times(seg_cams, dev):
    """View 0's label stage, each step alone: the segmentor and the numpy
    scan on the host (the scan that the one-hot kernel took over), then the
    upload as ``project_images`` does it and the one-hot kernel."""
    t0 = time.perf_counter()
    img = seg_cams.get_image_by_index(0)
    t1 = time.perf_counter()
    TexturedMesh._as_class_image(img)
    t2 = time.perf_counter()
    upload = PinnedUpload(dev)
    img_dev = upload(img)
    return dict(host_segment_s=round(t1 - t0, 4), host_class_image_s=round(t2 - t1, 4),
                h2d_onehot_ms=_cuda_ms(lambda: upload(img)),
                onehot_class_ms=_cuda_ms(lambda: onehot.onehot_to_class(img_dev)))


# one turn of the counts kernels' comparison: run with a tree's root as
# the working directory, it times that tree's wrapper on the saved inputs
AB_TURN = r"""
import json, os, statistics, sys
import torch
from geograypher_tpu_torch.ops import face_counts
here = os.path.realpath(os.getcwd()) + os.sep
assert os.path.realpath(face_counts.__file__).startswith(here), face_counts.__file__
data = torch.load(sys.argv[1])
p2f, n_faces, n_classes = data["p2f"].cuda(), data["n_faces"], data["n_classes"]
out = {}
for field in ("iid", "piecewise"):
    cls = data[field].cuda()
    call = lambda: face_counts.face_class_counts(p2f, cls, n_faces, n_classes)
    assert torch.equal(call(), face_counts.face_class_counts_plain(
        p2f, cls, n_faces, n_classes))
    times = []
    for _ in range(50):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    out[field] = statistics.median(times)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            call()
        torch.cuda.synchronize()
    out[field + "_device"] = sum(
        ev.self_device_time_total for ev in prof.key_averages()
        if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e4 or None
print(json.dumps(out))
"""


def _turns(parent_dir, script, inputs, what):
    """``script`` run on the saved ``inputs`` in the tree at ``parent_dir``
    and in this one, in turns parent, change, change, parent; every turn is
    a process of its own started in its tree.  Returns {"parent": [...],
    "change": [...]}, each turn's last line of output as JSON."""
    path = build.BUILD_DIR / f"{what}_inputs.pt"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    torch.save(inputs, path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    result = {"parent": [], "change": []}
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    try:
        for who in ("parent", "change", "change", "parent"):
            out = subprocess.run(
                [sys.executable, "-c", script, str(path)], text=True, env=env,
                cwd=parent_dir if who == "parent" else here, capture_output=True)
            if out.returncode:
                raise RuntimeError(f"{what} comparison, {who} turn:\n{out.stderr}")
            result[who].append(json.loads(out.stdout.strip().splitlines()[-1]))
    finally:
        path.unlink()
    result["seconds"] = round(time.perf_counter() - t0, 3)
    return result


def _ab_counts(parent_dir, p2f, cls, cls_piecewise, n_faces):
    """The counts wrapper of the tree at ``parent_dir`` and of this one on
    the same pix2face and label fields, in turns parent, change, change,
    parent; every turn is its own process (per field the median of 50
    timed calls, and the device time of a call's kernels)."""
    result = _turns(parent_dir, AB_TURN, {
        "p2f": p2f.cpu(), "iid": cls.cpu(), "piecewise": cls_piecewise.cpu(),
        "n_faces": n_faces, "n_classes": N_CLASSES}, "ab_counts")
    _line("ab_counts", order="parent, change, change, parent", **result)
    return result


# one turn of the front end's comparison: run with a tree's root as the
# working directory, it times that tree's setup, binning, census and whole
# fused chain on the saved view (medians of 20 timed calls), the setup
# kernel's device time by name (profiler, the L2 evicted before each of 5
# calls) and the host's time to enqueue a setup call (1,000 calls, no
# synchronise between them), and sums its counts
AB_FRONT_TURN = r"""
import json, os, statistics, sys, time
import torch
from torch.profiler import ProfilerActivity, profile, schedule
from geograypher_tpu_torch.ops import rasterize as tr
here = os.path.realpath(os.getcwd()) + os.sep
assert os.path.realpath(tr.__file__).startswith(here), tr.__file__
d = torch.load(sys.argv[1])
soa, w2c, f, cls = (d[k].cuda() for k in ("soa", "w2c", "f", "cls"))
lens = tuple(d[k].cuda() for k in ("dist8", "pcx", "pcy"))
cfg = tr.RasterConfig(caps=tuple(d["caps"]), bin_block=d["bin_block"],
                      l0_window=d["l0_window"], global_from=d["global_from"])
h, w = d["h"], d["w"]


def ms(fn, runs=20):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def chain():
    return tr.fused_view_class_counts(soa, w2c, f, *lens, cls, w, h, cfg, soa.shape[1],
                                      d["n_classes"], False)


def setup_call():
    return tr.setup_from_soa(soa, w2c, f, w, h, cfg.znear)


def setup_device_ms(runs=5, tries=10):
    evict = torch.empty(32 << 20, dtype=torch.int32, device="cuda")
    setup_call()
    torch.cuda.synchronize()
    for _ in range(tries):
        # a warm-up step of one call first, its events discarded; the host
        # waits 10 ms after the timed window opens and before it closes
        # (chip_smoke.py's _profile)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            evict.fill_(1)
            setup_call()
            torch.cuda.synchronize()
            prof.step()
            time.sleep(0.01)
            for _ in range(runs):
                evict.fill_(1)
                setup_call()
            torch.cuda.synchronize()
            time.sleep(0.01)
            prof.step()
        # one setup kernel and one fill a call: a trace that dropped a
        # launch of either is taken again, and after ``tries`` reads None
        us, launches, fills = 0.0, 0, 0
        for ev in prof.key_averages():
            if (ev.device_type != torch.autograd.DeviceType.CUDA
                    or ev.key.startswith("ProfilerStep")):
                continue
            if "triangle_setup" in ev.key:
                us, launches = us + ev.self_device_time_total, launches + ev.count
            elif ev.self_device_time_total > 0:
                fills += ev.count
        if launches == runs == fills:
            return us / 1e3 / launches
    return None


def host_us(fn, calls=1000):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    us = (time.perf_counter_ns() - t0) / calls / 1e3
    torch.cuda.synchronize()
    return us


setup = setup_call()
counts, over, _ = chain()
weights = torch.arange(counts.numel(), device=counts.device).remainder(97).double() + 1
out = dict(setup_ms=ms(setup_call), setup_device_ms=setup_device_ms(),
           setup_host_us=host_us(setup_call),
           binning_ms=ms(lambda: tr.binned_face_lists(tr.bin_triangles(setup, cfg, h, w),
                                                      cfg)),
           census_ms=ms(lambda: tr.bin_triangles(setup, cfg, h, w, return_census=True)),
           fused_chain_ms=ms(chain), overflow=int(over),
           counts_checksum=float((counts.double().flatten() * weights).sum()))
print(json.dumps(out))
"""


def _ab_front(parent_dir, soa, b, cls, cfg):
    """The front end of the tree at ``parent_dir`` and of this one on view
    0 (setup, binning with its face lists, the census, the whole fused chain), in
    turns parent, change, change, parent, one process a turn; the two
    trees' counts must agree."""
    result = _turns(parent_dir, AB_FRONT_TURN, {
        "soa": soa.cpu(), "w2c": b.world_to_cam[0].cpu(), "f": b.f[0].cpu(),
        "dist8": b.distortion[0].cpu(), "pcx": b.cx[0].cpu(), "pcy": b.cy[0].cpu(),
        "cls": cls.cpu(), "caps": list(cfg.caps), "bin_block": cfg.bin_block,
        "l0_window": cfg.l0_window, "global_from": cfg.global_from,
        "h": H, "w": W, "n_classes": N_CLASSES}, "ab_front")
    turns = result["parent"] + result["change"]
    if len({t["counts_checksum"] for t in turns}) != 1 or any(t["overflow"] for t in turns):
        raise RuntimeError(f"ab_front: the trees' view-0 counts differ: {result}")
    _line("ab_front", order="parent, change, change, parent", view=0, **result)
    return result


def _probe_inputs(soa, c2w, f):
    """(w2c, f) of a probe camera on the rows' device, as setup takes them."""
    return (torch.as_tensor(np.linalg.inv(c2w), dtype=torch.float32, device=soa.device),
            torch.tensor(f, device=soa.device))


def _probe_setup(soa, c2w, f, cfg):
    return setup_from_soa(soa, *_probe_inputs(soa, c2w, f), W, H, cfg.znear)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", metavar="DIR", default=None,
                        help="a checkout of another commit: its counts kernel and "
                             "its front end are timed in turns with this tree's")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit(
            "chip_smoke.py needs a CUDA device: torch.cuda.is_available() "
            "is False"
        )
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # -- phase 0: the card ----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _line(0, card=smi, device=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, python=sys.version.split()[0])

    # -- phase 1: build the kernels ---------------------------------------------
    t0 = time.perf_counter()
    build.load()
    log = (build.BUILD_DIR / "nvcc.log").read_text().splitlines()
    _line(1, build_s=round(time.perf_counter() - t0, 3),
          nvcc_s=round(build.last_build_seconds, 3),
          ptxas=[ln.strip() for ln in log if "registers" in ln or "spill" in ln])

    # -- the bench-scale mesh and the views --------------------------------------
    verts, faces, mesh, c2ws, sensors, sensor_ids, cams = _bench_scene(dev)
    n_faces = mesh.n_faces

    # main-path caps from the exact census over every view they serve
    cfg = mesh.raster_config
    soa = mesh._tri_soa_device(cams, cfg.bin_block)
    setups = []
    for i in range(len(cams)):
        b = cams.get_camera_batch([i], device=dev)
        use_dist = mesh._resolve_distortion(cams, i, None)
        setups.append(setup_from_soa(
            soa, b.world_to_cam[0], b.f[0], W, H, cfg.znear,
            distortion=(b.distortion[0], b.cx[0], b.cy[0]) if use_dist else None,
        ))
    nadir_c2w = nadir_camera(4.0, 2000.0, W)
    probe_cams = [
        ("nadir_f2000", nadir_c2w, 2000.0),
        ("oblique_f2600_p30",
         oblique_camera(4.0, 2600.0, W, pitch_deg=30.0, azimuth_deg=45.0), 2600.0),
    ]
    probes = [(name, _probe_setup(soa, c2w, f, cfg)) for name, c2w, f in probe_cams]
    census, caps = _census_caps(setups + [s for _, s in probes], cfg)
    cfg = dataclasses.replace(cfg, caps=caps)
    mesh.raster_config = cfg
    overflow = sum(int(bin_triangles(s, cfg, H, W).overflow) for s in setups)
    if overflow:
        raise RuntimeError(f"census-sized caps {caps} still overflow ({overflow})")
    _line("setup", faces=n_faces, census=census, caps=list(caps),
          cap_margin=CAP_MARGIN, overflow=overflow,
          seconds=round(time.perf_counter() - t_start, 3))

    # -- phase 2: each kernel against its plain version ----------------------------
    rng = np.random.default_rng(0)
    cls = torch.as_tensor(rng.integers(0, N_CLASSES, (H, W), dtype=np.int32),
                          device=dev)
    # the same draw served two ways: independent per pixel (above), and
    # constant over squares, as a segmentation's labels are
    cls_piecewise = torch.as_tensor(_piecewise_labels(rng, H, W), device=dev)
    # the front end's kernels against their plain versions on the four 4K
    # views (main configuration, bin_block=8, the low oblique view)
    for name, c2w, f in probe_cams:
        _front_vs_plain(name, soa, *_probe_inputs(soa, c2w, f), cfg)
    _setup_probe(soa, nadir_c2w, 2000.0, cfg)
    rows = [_kernel_vs_plain(name, s, cfg, n_faces, cls, cls_piecewise)
            for name, s in probes]
    ab = None
    if args.parent:
        p2f_ab, _ = rasterize_setup(probes[0][1], cfg, H, W)
        ab = _ab_counts(args.parent, p2f_ab, cls, cls_piecewise, n_faces)
        del p2f_ab
    # bin_block=8: faces ride along in 8-face units (padded mesh, own caps)
    cfg8 = dataclasses.replace(RasterConfig(), bin_block=8,
                               global_from=cfg.global_from)
    soa8 = mesh._tri_soa_device(cams, 8)
    setup8 = _probe_setup(soa8, nadir_c2w, 2000.0, cfg8)
    _, caps8 = _census_caps([setup8], cfg8)
    _front_vs_plain("nadir_f2000_bb8", soa8, *_probe_inputs(soa8, nadir_c2w, 2000.0),
                    dataclasses.replace(cfg8, caps=caps8))
    rows.append(_kernel_vs_plain("nadir_f2000", setup8,
                                 dataclasses.replace(cfg8, caps=caps8),
                                 soa8.shape[1], cls))
    # a low oblique view: its near faces span more than an L1 window
    # (L2 list) or an L2 window (global list), so the kernel's third
    # group runs at 4K
    near_c2w = oblique_camera(0.1, 2000.0, W, pitch_deg=60.0, azimuth_deg=0.0)
    near = _probe_setup(soa, near_c2w, 2000.0, cfg)
    census_near, caps_near = _census_caps([near], cfg)
    if census_near[2] == 0 or census_near[3] == 0:
        raise RuntimeError(f"near probe census {census_near}: no L2 or global "
                           "candidates")
    _front_vs_plain("near_oblique_p60", soa, *_probe_inputs(soa, near_c2w, 2000.0),
                    dataclasses.replace(cfg, caps=caps_near))
    rows.append(_kernel_vs_plain("near_oblique_p60", near,
                                 dataclasses.replace(cfg, caps=caps_near),
                                 n_faces, cls))
    # vertices on pixel centres, slivers, edges over 2^18 px: both
    # redesigned rasters against their plain versions
    _knife_edge_probe(cls, dev)
    # lists past the cut kernel's shared sort, a grid past the count
    # kernel's shared histogram
    _binning_probes(soa, cfg, dev)

    # the one-hot scan on view 0's image and on images it must refuse
    labels = rng.integers(0, N_CLASSES, (len(cams), H, W), dtype=np.int8)
    seg_cams = SegmentorCameraSet(cams, LabelSegmentor(labels, N_CLASSES))
    onehot_row = _onehot_probes(mesh, cams, seg_cams.get_image_by_index(0), dev)

    # -- phase 3: the main path ---------------------------------------------------
    _reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # the streaming loop (8 4K views would route to the planner: phase 6)
    avg, info = mesh.aggregate_projected_images(seg_cams, use_planned=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"raster_tiles": raster_tiles.launches,
                "face_class_counts": face_counts.launches,
                "onehot_class": onehot.launches,
                "triangle_setup": tri_setup.launches, "tile_binning": binning.launches}
    for name, n in launches.items():
        if n < len(cams):
            raise RuntimeError(f"{name} launched {n} times for {len(cams)} views")
    if launches["onehot_class"] != len(cams):
        raise RuntimeError(f"{launches['onehot_class']} one-hot scans for "
                           f"{len(cams)} views")
    seen = info["projection_counts"] > 0
    if avg.shape != (n_faces, N_CLASSES) or not np.isfinite(avg[seen]).all():
        raise RuntimeError(f"bad aggregate: shape {avg.shape}")
    if not np.isnan(avg[~seen]).all():
        raise RuntimeError("unseen faces must be NaN")
    if seen.mean() <= 0.5:
        raise RuntimeError(f"only {seen.mean():.3f} of faces were seen")
    frac_err = float(np.abs(avg[seen].sum(axis=1) - 1.0).max())
    if frac_err > 1e-5:
        raise RuntimeError(f"class fractions of seen faces sum off 1 by {frac_err}")
    peak_mem_gb = round(torch.cuda.max_memory_allocated() / 1e9, 3)
    # the same views with their class images from the numpy scan on the
    # host: the aggregate must not differ in one element
    state = init_aggregation(n_faces, N_CLASSES, dev)
    for i in range(len(cams)):
        b = cams.get_camera_batch([i], device=dev)
        cls_i = torch.as_tensor(
            mesh._as_class_image(seg_cams.get_image_by_index(i)), device=dev)
        if i == 0:
            cls0 = cls_i
        counts_i, _, _ = fused_view_class_counts(
            soa, b.world_to_cam[0], b.f[0], b.distortion[0], b.cx[0], b.cy[0],
            cls_i, W, H, cfg, soa.shape[1], N_CLASSES,
            mesh._resolve_distortion(cams, i, None))
        state = accumulate_view(
            state, counts_i, counts_i.sum(dim=1, keepdim=True).expand_as(counts_i))
    avg_host_scan = finalize_aggregation(state).cpu().numpy()
    if not np.array_equal(avg, avg_host_scan, equal_nan=True):
        raise RuntimeError(
            "the aggregate differs from the one built on the numpy scan's class "
            f"images in {int((~np.isclose(avg, avg_host_scan, 0, 0, True)).sum())} "
            "elements")
    del state
    _line(3, views=len(cams), seconds=round(dt, 4),
          views_per_s=round(len(cams) / dt, 4), launches=launches,
          seen_frac=round(float(seen.mean()), 6), frac_sum_err=frac_err,
          overflow=overflow, peak_mem_gb=peak_mem_gb,
          equals_host_scan_aggregate=True, **_label_stage_times(seg_cams, dev),
          card=smi)

    # view 0 again: the fused chain against the plain versions, bit for bit
    b0 = cams.get_camera_batch([0], device=dev)
    counts_k, over0, _ = fused_view_class_counts(
        soa, b0.world_to_cam[0], b0.f[0], b0.distortion[0], b0.cx[0],
        b0.cy[0], cls0, W, H, cfg, soa.shape[1], N_CLASSES, False)
    setup0 = setup_from_soa(soa, b0.world_to_cam[0], b0.f[0], W, H, cfg.znear)
    cand0, counts0 = binned_face_lists(bin_triangles(setup0, cfg, H, W), cfg)
    planes0 = setup0.planes.contiguous()
    p2f_k = raster_tiles.raster_tiles(planes0, setup0.bbox, cand0, counts0, cfg, H, W)
    p2f_p = raster_tiles.raster_tiles_plain(planes0, cand0, counts0, cfg, H, W)
    counts_p = face_counts.face_class_counts_plain(p2f_p, cls0, soa.shape[1], N_CLASSES)
    if (not torch.equal(p2f_k, p2f_p)
            or not torch.equal(counts_k, counts_p.to(torch.float32))
            or int(over0)):
        raise RuntimeError(
            f"view 0 kernels vs plain: {int((p2f_k != p2f_p).sum())} pixels "
            f"differ, sum|dcounts| {float((counts_k - counts_p).abs().sum())}, "
            f"overflow {int(over0)}"
        )
    # a small scene against the independent numpy brute-force oracle
    sv, sf = make_grid_mesh(n=15, size=4.0,
                            z_fn=lambda x, y: 0.25 * np.sin(2 * x) * np.cos(y))
    sc2w = oblique_camera(4.0, 50.0, 80, pitch_deg=20.0)
    tri = gather_tri_verts(sv, sf)
    w2c = np.linalg.inv(sc2w)
    tri_cam = (tri.reshape(-1, 3) @ w2c[:3, :3].T + w2c[:3, 3]).reshape(tri.shape)
    oracle = torch.as_tensor(brute_force_pix2face(tri_cam, 50.0, 80, 80), device=dev)
    small = rasterize_triangles(
        torch.as_tensor(tri_cam, dtype=torch.float32, device=dev), 50.0, 80, 80,
        RasterConfig(caps=(256, 64, 32, 32)))
    agree_s, bg_s = _knife_edge(small, oracle)
    if agree_s < ORACLE_MIN_AGREE or bg_s or not (oracle >= 0).any():
        raise RuntimeError(f"small scene vs oracle: agree {agree_s}, bg {bg_s}")
    _line("check", view0_pixels_differ=0, view0_counts_equal=True,
          oracle_agree=agree_s, oracle_bg_disagree=bg_s)

    # where one view's device time goes: each stage of the fused chain
    # timed alone with CUDA events (launch gaps included)
    cls_host = cls0.cpu()
    upload = PinnedUpload(dev)
    state = init_aggregation(n_faces, N_CLASSES, dev)
    for i in (0, 1, 6):
        b = cams.get_camera_batch([i], device=dev)
        use_dist = mesh._resolve_distortion(cams, i, None)
        dist_args = (b.distortion[0], b.cx[0], b.cy[0]) if use_dist else None
        # the view's one-hot image to the card: through the pinned staging
        # buffer, as project_images does it, against a pageable copy
        img_i = seg_cams.get_image_by_index(i)
        img_host = torch.as_tensor(img_i)
        (pageable_ms, _), (pinned_ms, pinned_spread) = _ab_ms(
            lambda: img_host.to(dev), lambda: upload(img_i), runs=3)
        img_dev = upload(img_i)

        def setup_i():
            return setup_from_soa(soa, b.world_to_cam[0], b.f[0], W, H,
                                  cfg.znear, distortion=dist_args)

        _front_vs_plain(f"view{i}", soa, b.world_to_cam[0], b.f[0], cfg, dist_args)
        s_i = setup_i()
        cand_i, counts_i = binned_face_lists(bin_triangles(s_i, cfg, H, W), cfg)
        p2f_i = raster_tiles.raster_tiles(s_i.planes, s_i.bbox, cand_i, counts_i,
                                          cfg, H, W)
        cls_i = cls_host.to(dev)
        counts_int = face_counts.face_class_counts(p2f_i, cls_i, soa.shape[1],
                                                   N_CLASSES)

        def view_tail():
            # what follows the counts kernel: the float cast, the row sum
            # and the fold into the running aggregate
            c = counts_int.to(torch.float32)[:n_faces]
            return accumulate_view(state, c,
                                   c.sum(dim=1, keepdim=True).expand_as(c))

        _line("breakdown", view=i, distorted=use_dist,
              h2d_onehot_ms=pinned_ms, h2d_onehot_spread_ms=pinned_spread,
              h2d_onehot_pageable_ms=pageable_ms,
              h2d_class_image_ms=_cuda_ms(lambda: cls_host.to(dev)),
              onehot_class_ms=_cuda_ms(lambda: onehot.onehot_to_class(img_dev)),
              setup_ms=_cuda_ms(setup_i),
              binning_ms=_cuda_ms(lambda: binned_face_lists(
                  bin_triangles(s_i, cfg, H, W), cfg)),
              raster_ms=_cuda_ms(lambda: raster_tiles.raster_tiles(
                  s_i.planes, s_i.bbox, cand_i, counts_i, cfg, H, W)),
              counts_ms=_cuda_ms(lambda: face_counts.face_class_counts(
                  p2f_i, cls_i, n_faces, N_CLASSES)),
              fused_chain_ms=_cuda_ms(lambda: fused_view_class_counts(
                  soa, b.world_to_cam[0], b.f[0], b.distortion[0], b.cx[0],
                  b.cy[0], cls_i, W, H, cfg, soa.shape[1], N_CLASSES, use_dist)),
              accumulate_ms=_cuda_ms(view_tail),
              list_entries=[int(c.sum()) for c in counts_i])
        del img_dev, img_host, img_i
    del state
    ab_front = None
    if args.parent:
        ab_front = _ab_front(args.parent, soa, b0, cls0, cfg)
    # -- phase 4: level S ------------------------------------------------------
    rows_s, launches_s = _level_s(mesh, cams, seg_cams, soa, cls, avg, info,
                                  nadir_c2w, smi)
    # -- phase 5: the render path, from a survey on disk -------------------------
    # caps from the census of every view's pinhole render (a distorted
    # sensor's mask is the remap of that), for a mesh loaded unsorted
    pinhole = []
    for i in range(len(cams)):
        b = cams.get_camera_batch([i], device=dev)
        pinhole.append(setup_from_soa(soa, b.world_to_cam[0], b.f[0], W, H, cfg.znear))
    census_r, caps_r = _census_caps(pinhole, RasterConfig())
    del pinhole
    _line("setup_r", census=census_r, caps=list(caps_r))
    with tempfile.TemporaryDirectory(prefix="gg_smoke_") as folder:
        survey, launches_r, launches_back = _render_phase(
            folder, verts, faces, c2ws, sensors, sensor_ids, RasterConfig(caps=caps_r),
            smi)
        # -- phase 6: planned aggregation; 6m: the means path ------------------
        launches_p, _ = _planned_phase(mesh, cams, seg_cams, labels, N_CLASSES, smi)
        launches_m, sums_row = _means_phase(mesh, cams, H, W, N_CLASSES, smi)
        # -- phase 7: the survey pipeline, 20 views of the bench suite ---------
        names_p = [f"view_{k:02d}.png" for k in range(PIPELINE_VIEWS)]
        cams_p = CameraSet(_suite_cameras(n_views=PIPELINE_VIEWS), sensors,
                           image_filenames=names_p,
                           sensor_IDs=_suite_sensor_ids(PIPELINE_VIEWS))
        labels_p = np.random.default_rng(7).integers(
            0, N_CLASSES, (PIPELINE_VIEWS, H, W), dtype=np.int8)
        devices = [torch.device("cuda", 0)] * 2  # two shards on the one card
        launches_7, _ = _pipeline_phase(mesh, cams_p, labels_p, N_CLASSES, devices, smi)
        # -- phase 7c: chunked aggregation and rendering, view sharding --------
        launches_7a, fields_a = _chunked_aggregate_check(
            mesh, SegmentorCameraSet(cams_p, LabelSegmentor(labels_p, N_CLASSES,
                                                            names_p)), N_CLASSES)
        launches_7r, fields_r = _chunked_render_check(survey, RasterConfig(caps=caps_r))
        launches_7s, fields_s = _sharded_check(mesh, cams, cfg, devices, N_CLASSES)
        _line("7c", **fields_a, **fields_r, **fields_s, card=smi)
        del labels_p
        # -- phase 8: the detection workflow on phase 7's 20 views -------------
        # caps from the census of every view's pinhole render (the raster
        # of a distorted view is remapped)
        pinhole = []
        for i in range(PIPELINE_VIEWS):
            b = cams_p.get_camera_batch([i], device=dev)
            pinhole.append(setup_from_soa(soa, b.world_to_cam[0], b.f[0], W, H,
                                          cfg.znear))
        census_d, caps_d = _census_caps(pinhole, RasterConfig())
        del pinhole
        _line("setup_d", census=census_d, caps=list(caps_d))
        launches_8, det_row = _detection_phase(
            folder, verts, faces, _suite_cameras(n_views=PIPELINE_VIEWS), sensors,
            _suite_sensor_ids(PIPELINE_VIEWS), RasterConfig(caps=caps_d), card=smi)
        # -- phase 9: DTM, orthographic raster, polygons on phase 8's survey ---
        survey_8 = _survey_of(Path(folder) / "detections")
        launches_9, ortho_row, ortho_big_row, big = _phase9(
            folder, survey_8, verts, RasterConfig(caps=caps_d), dev, card=smi)
        # -- phase 10: image selection; ortho chips, assembly and metrics ------
        t10 = time.perf_counter()
        picks = {}
        launches_10 = _selection_phase(folder, survey_8, sensors, dev, card=smi,
                                       picks=picks)
        _ortho_predict_phase(folder, survey_8, big, dev, card=smi)
        del big
        _line("10", seconds=round(time.perf_counter() - t10, 3), launches=launches_10)
        # -- phase 11: COLMAP, the 360 rig, composites and viewers,
        # rasterize_batch and selection at its default caps -------------------
        t11 = time.perf_counter()
        launches_11 = [
            _colmap_phase(folder, mesh, sensors, dev, card=smi),
            _rig_phase(folder, dev, card=smi),
            _composite_phase(folder, survey, c2ws, sensors, sensor_ids, caps_r, dev,
                             card=smi),
            _batch_phase(mesh, cams, cfg, caps_r, dict(
                mesh_file=survey_8["mesh_file"],
                cameras_file=Path(folder) / "selection_cameras.xml"), picks["10a"], dev,
                card=smi),
        ]
        launches_11 = {name: sum(row[name] for row in launches_11)
                       for name in launches_11[0]}
        _line("11", seconds=round(time.perf_counter() - t11, 3), launches=launches_11)
        # -- phase 12: the example scripts, on the card against the CPU -------
        launches_12 = _examples_phase(Path(folder) / "examples", card=smi)
    _line("done", total_s=round(time.perf_counter() - t_start, 3))
    # the kernels' launches on phases 7, 7c, 8, 9, 10, 11 and 12's paths
    later = {name: launches_7[name] + launches_7a[name] + launches_7r[name]
             + launches_7s[name] + launches_8[name] + launches_9[name]
             + launches_10[name] + launches_11[name] + launches_12[name]
             for name in launches_7}

    # one line per kernel: launches are the main paths' (phase 3, the
    # level-S path, phase 5's two entry points, phase 6's planned route,
    # phase 6m's first means run, phase 7's main run, phase 7c's chunked
    # aggregation, chunked render and one-device sharded run, phase 8's
    # project_detections, the paths of phases 9-11 and phase 12's card runs
    # of the eight example scripts); times and bounds
    # are the kernel-vs-plain views at the main path's configuration
    # (phase 2's first two views; level S: its two views at the S
    # configuration; face_sums: view 0)
    def mean(rs, key):
        values = [r[key] for r in rs]
        return None if None in values else statistics.mean(values)

    main_rows = rows[:2]
    all_rows = rows + rows_s
    kernels = [
        dict(name="raster_tiles", route="cuda",
             source="geograypher_tpu_torch/csrc/raster_tiles.cu",
             replaces=TPU_KERNELS["B1"],
             launches=(launches["raster_tiles"] + launches_s["raster_tiles"]
                       + launches_r["raster_tiles"] + launches_back["raster_tiles"]
                       + launches_p["raster_tiles"] + launches_m["raster_tiles"]
                       + later["raster_tiles"]),
             max_abs_err=max(r["raster_max_abs_err"] for r in all_rows),
             ms=mean(main_rows, "raster_ms"),
             plain_ms=mean(main_rows, "raster_plain_ms"),
             bound_ms=mean(main_rows, "raster_bound_ms"),
             bound_by=main_rows[0]["raster_bound_by"], library_ms=None,
             # phase 9b: the orthographic camera (f ~1e5) at ~2500 px and on
             # one ~5000 px tile of the ~10000 px ortho
             ortho_shape=ortho_row["shape"], ortho_ms=ortho_row["ms"],
             ortho_plain_ms=ortho_row["plain_ms"], ortho_bound_ms=ortho_row["bound_ms"],
             ortho_big_shape=ortho_big_row["shape"], ortho_big_ms=ortho_big_row["ms"],
             ortho_big_plain_ms=ortho_big_row["plain_ms"],
             ortho_big_bound_ms=ortho_big_row["bound_ms"]),
        dict(name="face_class_counts", route="cuda",
             source="geograypher_tpu_torch/csrc/face_class_counts.cu",
             replaces=", ".join(TPU_KERNELS[k] for k in ("B2", "B3", "B4", "B6")),
             launches=(launches["face_class_counts"]
                       + launches_s["face_class_counts"]
                       + launches_back["face_class_counts"]
                       + launches_p["face_class_counts"] + later["face_class_counts"]),
             max_abs_err=max(r["counts_max_abs_err"] for r in all_rows),
             ms=mean(main_rows, "counts_ms"),
             plain_ms=mean(main_rows, "counts_plain_ms"),
             bound_ms=mean(main_rows, "counts_bound_ms"),
             bound_by=main_rows[0]["counts_bound_by"],
             library_ms=mean(main_rows, "counts_library_ms"),
             # ms and its neighbours: labels drawn independently per pixel;
             # piecewise: constant over 64 x 64 pixel squares; device_ms:
             # the zero fill and the kernel on the device (profiler)
             device_ms=mean(main_rows, "counts_device_ms"),
             piecewise_ms=mean(main_rows, "counts_piecewise_ms"),
             piecewise_plain_ms=mean(main_rows, "counts_piecewise_plain_ms"),
             piecewise_library_ms=mean(main_rows, "counts_piecewise_library_ms"),
             piecewise_device_ms=mean(main_rows, "counts_piecewise_device_ms"),
             # in turns with the --parent tree's wrapper (the ab_counts line)
             turns=ab,
             # phase 8's shape: view 0's own detections as the classes
             detection_classes=det_row["classes"], detection_ms=det_row["ms"],
             detection_plain_ms=det_row["plain_ms"],
             detection_bound_ms=det_row["bound_ms"],
             detection_library_ms=det_row["library_ms"],
             detection_nonzero_ms=det_row["nonzero_ms"],
             detection_max_abs_err=det_row["max_abs_err"]),
        dict(name="s_raster", route="cuda",
             source="geograypher_tpu_torch/csrc/s_raster.cu",
             replaces=TPU_KERNELS["B5"],
             launches=launches_s["s_raster"] + later["s_raster"],
             max_abs_err=max(r["s_raster_max_abs_err"] for r in rows_s),
             ms=mean(rows_s, "s_raster_ms"),
             plain_ms=mean(rows_s, "s_raster_plain_ms"),
             bound_ms=mean(rows_s, "s_raster_bound_ms"),
             bound_by=rows_s[0]["s_raster_bound_by"], library_ms=None),
        dict(name="onehot_class", route="cuda",
             source="geograypher_tpu_torch/csrc/onehot_class.cu",
             replaces=ONEHOT_REPLACES,
             launches=(launches["onehot_class"] + launches_s["onehot_class"]
                       + launches_back["onehot_class"] + launches_p["onehot_class"]
                       + launches_m["onehot_class"] + later["onehot_class"]),
             max_abs_err=onehot_row["max_abs_err"], ms=onehot_row["float32"]["ms"],
             plain_ms=onehot_row["float32"]["plain_ms"],
             bound_ms=onehot_row["float32"]["bound_ms"], bound_by="bytes",
             library_ms=None, float64_ms=onehot_row["float64"]["ms"],
             float64_plain_ms=onehot_row["float64"]["plain_ms"],
             float64_bound_ms=onehot_row["float64"]["bound_ms"],
             device_ms=onehot_row["float32"]["device_ms"],
             device_kernels_ms=onehot_row["float32"]["device_kernels"],
             float64_device_ms=onehot_row["float64"]["device_ms"]),
        dict(name="face_sums", route="cuda",
             source="geograypher_tpu_torch/csrc/face_sums.cu",
             replaces=FACE_SUMS_REPLACES,
             launches=launches_m["face_sums"] + later["face_sums"],
             max_abs_err=sums_row["max_abs_err"], ms=sums_row["ms"],
             plain_ms=sums_row["plain_ms"], bound_ms=sums_row["bound_ms"],
             bound_by=sums_row["bound_by"], library_ms=sums_row["library_ms"],
             # face_to_vert_texture's sum on the mesh's 3F vertex keys
             vertex_ms=sums_row["vertex"]["ms"],
             vertex_plain_ms=sums_row["vertex"]["plain_ms"],
             vertex_bound_ms=sums_row["vertex"]["bound_ms"],
             vertex_library_ms=sums_row["vertex"]["library_ms"]),
    ]
    # the front end: times and bounds at the main configuration on phase 2's
    # first two views; through the lens on view 6; at the selection's scale
    # on 10a's views
    front_main = [FRONT_ROWS[k] for k in ("nadir_f2000", "oblique_f2600_p30")]
    lens = FRONT_ROWS["view6"]
    small = [r for k, r in FRONT_ROWS.items() if k.startswith("10a")]
    front_launches = {
        k: (launches[k] + launches_s[k] + launches_r[k] + launches_back[k] + launches_p[k]
            + launches_m[k] + later[k]) for k in FRONT}
    kernels += [
        dict(name="triangle_setup", route="cuda",
             source="geograypher_tpu_torch/csrc/triangle_setup.cu",
             replaces=SETUP_REPLACES, launches=front_launches["triangle_setup"],
             max_abs_err=max(r["setup_max_abs_err"] for r in FRONT_ROWS.values()),
             ms=mean(front_main, "setup_ms"), plain_ms=mean(front_main, "setup_plain_ms"),
             bound_ms=mean(front_main, "setup_bound_ms"),
             bound_by=front_main[0]["setup_bound_by"], library_ms=None,
             device_ms=mean(front_main, "setup_device_ms"),
             lens_ms=lens["setup_ms"], lens_plain_ms=lens["setup_plain_ms"],
             lens_bound_ms=lens["setup_bound_ms"],
             selection_ms=mean(small, "setup_ms"),
             selection_plain_ms=mean(small, "setup_plain_ms"),
             selection_bound_ms=mean(small, "setup_bound_ms"),
             views_equal=sorted(FRONT_ROWS)),
        dict(name="tile_binning", route="cuda",
             source="geograypher_tpu_torch/csrc/tile_binning.cu",
             replaces=BINNING_REPLACES, launches=front_launches["tile_binning"],
             max_abs_err=max(r["binning_max_abs_err"] for r in FRONT_ROWS.values()),
             ms=mean(front_main, "binning_ms"), plain_ms=mean(front_main, "binning_plain_ms"),
             bound_ms=mean(front_main, "binning_bound_ms"),
             bound_by=front_main[0]["binning_bound_by"],
             # no PyTorch call computes the lists
             library_ms=None,
             device_ms=mean(front_main, "binning_device_ms"),
             device_kernels_ms=[r["binning_device_kernels"] for r in front_main],
             census_ms=mean(front_main, "census_ms"),
             census_device_ms=mean(front_main, "census_device_ms"),
             census_plain_ms=mean(front_main, "census_plain_ms"),
             census_bound_ms=mean(front_main, "census_bound_ms"),
             selection_ms=mean(small, "binning_ms"),
             selection_plain_ms=mean(small, "binning_plain_ms"),
             selection_bound_ms=mean(small, "binning_bound_ms"),
             # the probes: lists past the shared sort, a grid past the
             # shared histogram
             crowded_ms=FRONT_ROWS["crowded"]["binning_ms"],
             crowded_device_ms=FRONT_ROWS["crowded"]["binning_device_ms"],
             crowded_bound_ms=FRONT_ROWS["crowded"]["binning_bound_ms"],
             grid_8192_ms=FRONT_ROWS["grid_8192"]["binning_ms"],
             grid_8192_device_ms=FRONT_ROWS["grid_8192"]["binning_device_ms"],
             grid_8192_bound_ms=FRONT_ROWS["grid_8192"]["binning_bound_ms"],
             turns=ab_front, views_equal=sorted(FRONT_ROWS)),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def _level_s(mesh, cams, seg_cams, soa, cls, avg, info, nadir_c2w, smi):
    """Phase 4: the level-S configuration on the same mesh and views.
    Returns (kernel-vs-plain rows, the S path's launch counts)."""
    dev = soa.device
    soa8 = mesh._tri_soa_device(cams, 8)  # padded to a multiple of 8
    n_pad = soa8.shape[1]
    base = RasterConfig(bin_block=8, l0_window=(5, 2),
                        global_from=mesh.raster_config.global_from)
    cfg_s = dataclasses.replace(base, subtile=(8, 16), s_window=(3, 2), s_block=4)
    setups = []
    for i in range(len(cams)):
        b = cams.get_camera_batch([i], device=dev)
        use_dist = mesh._resolve_distortion(cams, i, None)
        setups.append(setup_from_soa(
            soa8, b.world_to_cam[0], b.f[0], W, H, base.znear,
            distortion=(b.distortion[0], b.cx[0], b.cy[0]) if use_dist else None,
        ))
    probes = [
        ("nadir_f2000", _probe_setup(soa8, nadir_c2w, 2000.0, base)),
        ("oblique_f2600_p30", _probe_setup(
            soa8, oblique_camera(4.0, 2600.0, W, pitch_deg=30.0, azimuth_deg=45.0),
            2600.0, base)),
    ]
    census_s, caps_s = _census_caps(setups + [s for _, s in probes], cfg_s)
    census_off, caps_off = _census_caps(setups + [s for _, s in probes], base)
    cfg_s = dataclasses.replace(cfg_s, caps=caps_s)
    cfg_off = dataclasses.replace(base, caps=caps_off)
    overflow = sum(int(bin_all(s, cfg_s, H, W)[0].overflow) for s in setups)
    if overflow:
        raise RuntimeError(f"level-S census caps {caps_s} overflow ({overflow})")
    _line("setup_s", padded_faces=n_pad, census_s=census_s, caps_s=list(caps_s),
          census_off=census_off, caps_off=list(caps_off), overflow=overflow)

    # the three kernels against their plain versions, bit for bit
    rows = [_s_kernels_vs_plain(name, s, cfg_s, n_pad, cls) for name, s in probes]

    _front_vs_plain("s_nadir_f2000", soa8, *_probe_inputs(soa8, nadir_c2w, 2000.0), cfg_s)
    # the S path through the entry point
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    avg_s, info_s = mesh.aggregate_projected_images(seg_cams, config=cfg_s,
                                                    use_planned=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"raster_tiles": raster_tiles.launches,
                "face_class_counts": face_counts.launches,
                "s_raster": subtile.launches,
                "onehot_class": onehot.launches,
                "triangle_setup": tri_setup.launches, "tile_binning": binning.launches}
    for name, n in launches.items():
        if n < len(cams):
            raise RuntimeError(f"level S: {name} launched {n} times for "
                               f"{len(cams)} views")
    if launches["onehot_class"] != len(cams):
        raise RuntimeError(f"level S: {launches['onehot_class']} one-hot scans for "
                           f"{len(cams)} views")
    seen = info_s["projection_counts"] > 0
    if avg_s.shape != avg.shape or not np.isfinite(avg_s[seen]).all():
        raise RuntimeError(f"level S: bad aggregate, shape {avg_s.shape}")
    if not np.isnan(avg_s[~seen]).all():
        raise RuntimeError("level S: unseen faces must be NaN")
    frac_err = float(np.abs(avg_s[seen].sum(axis=1) - 1.0).max())
    if frac_err > 1e-5:
        raise RuntimeError(f"level S: class fractions sum off 1 by {frac_err}")
    # against the main path (level S off, bin_block=1): the pix2face maps
    # differ only on exact 1/z ties, so nearly every face's counts agree
    same_counts = float((info_s["summed_projections"]
                         == info["summed_projections"]).all(axis=1).mean())
    if same_counts < 0.99:
        raise RuntimeError(f"level S vs main path: only {same_counts} of faces "
                           "have equal counts")
    _line(4, views=len(cams), seconds=round(dt, 4),
          views_per_s=round(len(cams) / dt, 4), launches=launches,
          seen_frac=round(float(seen.mean()), 6), frac_sum_err=frac_err,
          overflow=overflow, faces_equal_to_main_path=same_counts,
          **_label_stage_times(seg_cams, dev), card=smi)

    # view 0: level S on against off, and the unfused counts (B4's
    # counterpart) on its pix2face
    p2f_on, binned_on = rasterize_setup(setups[0], cfg_s, H, W)
    p2f_off, binned_off = rasterize_setup(setups[0], cfg_off, H, W)
    agree, bg = _knife_edge(p2f_on, p2f_off)
    if agree < S_MIN_AGREE or bg or int(binned_on.overflow) or int(binned_off.overflow):
        raise RuntimeError(f"view 0 level S on vs off: agreement {agree}, {bg} "
                           "face-vs-background")
    cls0 = torch.as_tensor(mesh._as_class_image(seg_cams.get_image_by_index(0)),
                           device=dev)
    tiled, tiled_over = project_image_class_counts_tiled(
        p2f_on, cls0, binned_on, cfg_s, H, W, n_pad, N_CLASSES)
    tiled_plain = face_counts.face_class_counts_plain(p2f_on, cls0, n_pad, N_CLASSES)
    if not torch.equal(tiled, tiled_plain.to(torch.float32)) or int(tiled_over):
        raise RuntimeError("unfused counts vs plain on view 0 (level S) differ")
    _line("check_s", view0_s_on_off_agree=agree, view0_s_on_off_bg=bg,
          view0_s_on_off_pixels_differ=int((p2f_on != p2f_off).sum()),
          view0_tiled_counts_equal=True,
          tiled_ms=_cuda_ms(lambda: project_image_class_counts_tiled(
              p2f_on, cls0, binned_on, cfg_s, H, W, n_pad, N_CLASSES)),
          tiled_plain_ms=_cuda_ms(lambda: face_counts.face_class_counts_plain(
              p2f_on, cls0, n_pad, N_CLASSES)),
          tiled_library_ms=_counts_library_ms(p2f_on, cls0, n_pad),
          tiled_bound_ms=_counts_bound(n_pad)[0], card=smi)

    # where one view's device time goes with level S on, and at
    # bin_block=8 with it off
    cls_host = cls0.cpu()
    for i in (0, 1, 6):
        b = cams.get_camera_batch([i], device=dev)
        use_dist = mesh._resolve_distortion(cams, i, None)
        s_i = setups[i]
        binned_i, su_i = bin_all(s_i, cfg_s, H, W)
        cand_i, counts_i = binned_face_lists(binned_i, cfg_s)
        planes_i, bbox_i = s_i.planes.contiguous(), s_i.bbox
        init_i = subtile.s_raster(su_i, s_i, cfg_s, H, W)
        cand_o, counts_o = binned_face_lists(bin_triangles(s_i, cfg_off, H, W), cfg_off)
        cls_i = cls_host.to(dev)

        def chain(cfg):
            return fused_view_class_counts(
                soa8, b.world_to_cam[0], b.f[0], b.distortion[0], b.cx[0],
                b.cy[0], cls_i, W, H, cfg, n_pad, N_CLASSES, use_dist)

        (on_ms, on_spread), (off_ms, off_spread) = _ab_ms(
            lambda: chain(cfg_s), lambda: chain(cfg_off))
        if i == 0:
            # device kernels of each chain and the device's busy share of
            # the window (the rest is launch gaps and host work)
            busy_on, top_on = _profile(lambda: chain(cfg_s))
            busy_off, top_off = _profile(lambda: chain(cfg_off))
            _line("profile_s", view=i, s_on_busy_share=busy_on,
                  s_on_kernels_ms=top_on, s_off_busy_share=busy_off,
                  s_off_kernels_ms=top_off, card=smi)
        _line("breakdown_s", view=i, distorted=use_dist,
              s_prep_ms=_cuda_ms(lambda: subtile.subtile_units(s_i, cfg_s)),
              tile_binning_ms=_cuda_ms(lambda: binned_face_lists(bin_triangles(
                  s_i, cfg_s, H, W, exclude_blocks=su_i.s_mask8), cfg_s)),
              s_raster_ms=_cuda_ms(lambda: subtile.s_raster(
                  su_i, s_i, cfg_s, H, W)),
              raster_carry_ms=_cuda_ms(lambda: raster_tiles.raster_tiles(
                  planes_i, bbox_i, cand_i, counts_i, cfg_s, H, W, s_init=init_i)),
              fused_chain_ms=on_ms, fused_chain_spread_ms=on_spread,
              off_binning_ms=_cuda_ms(lambda: binned_face_lists(
                  bin_triangles(s_i, cfg_off, H, W), cfg_off)),
              off_raster_ms=_cuda_ms(lambda: raster_tiles.raster_tiles(
                  planes_i, bbox_i, cand_o, counts_o, cfg_off, H, W)),
              off_fused_chain_ms=off_ms, off_fused_chain_spread_ms=off_spread,
              list_entries=[int(c.sum()) for c in counts_i],
              off_list_entries=[int(c.sum()) for c in counts_o],
              # (sub-tile, unit) pairs and the most units of one sub-tile
              s_census=subtile.subtile_counts_census(s_i, cfg_s, H, W).tolist(),
              card=smi)
    return rows, launches


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _reset_launches():
    raster_tiles.launches = face_counts.launches = subtile.launches = 0
    onehot.launches = face_sums.launches = 0
    tri_setup.launches = binning.launches = 0


def _launches():
    return {"raster_tiles": raster_tiles.launches,
            "face_class_counts": face_counts.launches,
            "s_raster": subtile.launches, "onehot_class": onehot.launches,
            "face_sums": face_sums.launches,
            "triangle_setup": tri_setup.launches, "tile_binning": binning.launches}


def _back(launches):
    """The launches of the kernels behind the front end (raster, counts,
    one-hot, sums): the counts a path's checks compare exactly."""
    return {k: n for k, n in launches.items() if k not in FRONT}


def _demand_front(phase, launches, n):
    """Raise unless the setup and binning kernels launched at least ``n``
    times each (a view sets up and bins at least once; a census, a retry
    or a remap adds more)."""
    short = {k: launches[k] for k in FRONT if launches[k] < n}
    if short:
        raise RuntimeError(f"{phase}: front-end launches {short}, expected >= {n} each "
                           "(a path took the plain setup or binning)")


def _timed(dev, fn):
    """(result, seconds) of ``fn()`` ended by a synchronise."""
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


def _planned_phase(mesh, cams, seg_cams, labels, n_classes, card=None,
                   forced_caps=(16, 16, 16, 16)):
    """Phase 6: planned aggregation at the bench's binning configuration
    (``bin_block=8, l0_window=(5, 2)``) and the library's DEFAULT caps.

    The pooled counts (``aggregate_class_images_planned``) must equal the
    streaming chain's per-view counts summed at the plan's census-sized
    caps, and the planned route of ``aggregate_projected_images`` (the
    one-hot scan on the device, int8 class images, the weighted planner)
    the streaming mean: view counts exactly, the mean to
    ``PLANNED_MEAN_RTOL``, NaN on the same faces.  Neither may raise or
    retry (launches exactly one per view).  A plan forced to ``forced_caps``
    must end equal after its retry.  Returns (the route's launches, fields
    of the phase line)."""
    dev = mesh.device
    n = len(cams)
    cfg = dataclasses.replace(DEFAULT_RASTER_CONFIG, bin_block=8, l0_window=(5, 2),
                              global_from=mesh.raster_config.global_from)
    _reset_launches()
    (counts, plan), pooled_s = _timed(dev, lambda: mesh.aggregate_class_images_planned(
        cams, n_classes, labels=labels, config=cfg))
    pooled_launches = _launches()
    k = int(torch.device(dev).type == "cuda")  # CPU tensors launch nothing
    want = {"raster_tiles": n * k, "face_class_counts": n * k, "s_raster": 0,
            "onehot_class": 0, "face_sums": 0}
    if _back(pooled_launches) != want:
        raise RuntimeError(f"planned pooled run: launches {pooled_launches}, "
                           f"expected {want} (a retry or a stray path)")
    _demand_front("planned pooled run", pooled_launches, n * k)
    # the streaming chain at the plan's census-sized caps, on the same views
    cover = plan.cover_config
    pooled_ref = torch.zeros((mesh.n_faces, n_classes), device=dev)
    state = init_aggregation(mesh.n_faces, n_classes, dev)
    for sums, cnt in mesh.project_images(seg_cams, config=cover):
        pooled_ref += sums
        state = accumulate_view(state, sums, cnt)
    if not np.array_equal(counts, pooled_ref.cpu().numpy()):
        raise RuntimeError(
            "planned pooled counts differ from the streaming chain's in "
            f"{int((counts != pooled_ref.cpu().numpy()).sum())} elements")
    ref_avg = finalize_aggregation(state).cpu().numpy()
    ref_count = state.view_count.cpu().numpy()
    del pooled_ref, state
    # the main path of the phase: the planned route, from one-hot images
    _reset_launches()
    (avg, info), route_s = _timed(dev, lambda: mesh.aggregate_projected_images(
        seg_cams, use_planned=True, config=cfg))
    launches = _launches()
    want = dict(want, onehot_class=n * k)
    if _back(launches) != want or "plan" not in info:
        raise RuntimeError(f"planned route: launches {launches}, expected {want}")
    _demand_front("planned route", launches, n * k)
    if not np.array_equal(info["projection_counts"], ref_count):
        raise RuntimeError("planned route: view counts differ from streaming")
    if not np.array_equal(np.isnan(avg), np.isnan(ref_avg)):
        raise RuntimeError("planned route: NaN on other faces than streaming")
    seen = ref_count > 0
    rel = float(np.max(np.abs(avg[seen] - ref_avg[seen])
                       / np.maximum(np.abs(ref_avg[seen]), 1e-30)))
    if not np.allclose(avg, ref_avg, rtol=PLANNED_MEAN_RTOL, atol=1e-7,
                       equal_nan=True):
        raise RuntimeError(f"planned route: mean off streaming by rtol {rel}")
    # the same views' labels as int class images from a provider
    _, provider_s = _timed(dev, lambda: mesh.aggregate_projected_images_planned(
        cams, n_classes, class_image_provider=lambda i: labels[i], config=cfg))
    # a plan whose caps every view overflows: gated, re-censused, re-run
    tri_soa, params, host_labels, h, w, use_dist, _, _ = mesh._planned_inputs(
        cams, n_classes, None, 1.0, cfg, None, 4, None, labels)
    forced = dataclasses.replace(plan, buckets=(planner.BucketPlan(
        dataclasses.replace(cfg, caps=tuple(forced_caps)), tuple(range(n))),))
    agg = planner.PlannedAggregator(forced, n_classes)
    agg.prepare(tri_soa, params, host_labels)
    agg.run()
    forced_counts = agg.finalize()[: mesh.n_faces]
    if agg.resizes < 1 or not np.array_equal(forced_counts, counts):
        raise RuntimeError(f"forced plan: {agg.resizes} resizes, equal "
                           f"{np.array_equal(forced_counts, counts)}")
    # run + finalize at one bucket against four: a warm-up each, then
    # turns 1, 4, 4, 1
    runs, rates = {}, {1: [], 4: []}
    for mb in (1, 4):
        runs[mb] = planner.PlannedAggregator(planner.plan_aggregation(
            tri_soa, params, cfg, h, w, tri_soa.shape[1], use_dist=use_dist,
            max_buckets=mb), n_classes)
        runs[mb].prepare(tri_soa, params, host_labels)
    for mb in (1, 4, 1, 4, 4, 1):

        def go(agg=runs[mb]):
            agg.run()
            return agg.finalize()

        out, sec = _timed(dev, go)
        if not np.array_equal(out[: mesh.n_faces], counts):
            raise RuntimeError(f"max_buckets={mb}: counts differ")
        rates[mb].append(n / sec)
    rates = {mb: r[1:] for mb, r in rates.items()}  # the first of each: warm-up
    fields = dict(
        views=n, config=dict(bin_block=cfg.bin_block, l0_window=list(cfg.l0_window),
                             caps_given=list(cfg.caps)),
        plan_s=round(plan.plan_seconds, 4),
        census_ms_per_view=round(plan.plan_seconds / n * 1e3, 3),
        buckets=[dict(caps=list(b.config.caps), views=list(b.view_indices))
                 for b in plan.buckets],
        use_dist=plan.use_dist, pooled_s=round(pooled_s, 4),
        pooled_views_per_s=round(n / pooled_s, 4), pooled_launches=pooled_launches,
        pooled_equals_streaming=True, route_s=round(route_s, 4),
        route_views_per_s=round(n / route_s, 4), launches=launches,
        route_view_counts_equal=True, route_mean_max_rel_err=rel,
        route_s_per_view=round(route_s / n, 4), provider_s=round(provider_s, 4),
        provider_views_per_s=round(n / provider_s, 4),
        provider_s_per_view=round(provider_s / n, 4),
        forced_caps=list(forced_caps), forced_resizes=agg.resizes,
        forced_equal=True,
        max_buckets_1_views_per_s=[round(r, 4) for r in rates[1]],
        max_buckets_4_views_per_s=[round(r, 4) for r in rates[4]],
        card=card)
    _line(6, **fields)
    return launches, fields


def _means_phase(mesh, cams, h, w, n_classes, card=None, timing=True):
    """Phase 6m: the means path (a soft image no one-hot scan accepts)
    twice through ``aggregate_projected_images`` on a pinhole and a
    distorted view: the same bits both times; then the ``face_sums``
    kernels against their plain version on view 0's pix2face (32 x 32
    tiles) and on the mesh's 3F vertex keys (``face_to_vert_texture``'s
    sum, runs of 1024), bit for bit, with their times, ``index_add``'s,
    and the wrapper's launches by name (profiler; no sort may appear).
    Returns (the first run's launches, the kernel's row)."""
    dev = mesh.device
    rng = np.random.default_rng(6)
    soft = rng.random((h, w, n_classes), dtype=np.float32)
    soft[: h // 16] = np.nan  # unlabelled rows, skipped
    views = [0, len(cams) - 1]
    soft_cams = SegmentorCameraSet(cams.get_subset_cameras(views),
                                   ImageSegmentor([soft, soft]))
    runs = []
    for _ in range(2):
        _reset_launches()
        runs.append((mesh.aggregate_projected_images(soft_cams), _launches()))
    (avg, info), launches = runs[0]
    on_card = torch.device(dev).type == "cuda"
    want = {"raster_tiles": 2 * on_card, "face_class_counts": 0, "s_raster": 0,
            "onehot_class": 2 * on_card, "face_sums": 2 * on_card}
    if _back(launches) != want:
        raise RuntimeError(f"means path: launches {launches}, expected {want}")
    _demand_front("means path", launches, 2 * on_card)
    (avg2, info2), _ = runs[1]
    same = all(np.array_equal(a, b, equal_nan=True) for a, b in (
        (avg, avg2), (info["summed_projections"], info2["summed_projections"]),
        (info["projection_counts"], info2["projection_counts"])))
    if not same or not (info["projection_counts"] > 0).any():
        raise RuntimeError("means path: two runs on the same inputs differ")
    # the kernel against its plain version on view 0's pix2face
    p2f, _ = mesh._rasterize_view(cams, 0, 1.0, None, mesh.raster_config)
    keys = p2f.reshape(-1)
    values = torch.as_tensor(soft).to(dev).reshape(-1, n_classes)
    shape = (h, w)
    sums, counts = face_sums.face_sums(keys, values, mesh.n_faces, shape=shape)
    sums_p, counts_p = face_sums.face_sums_plain(keys, values, mesh.n_faces, shape)
    _sync(dev)
    if not (torch.equal(sums, sums_p) and torch.equal(counts, counts_p)):
        raise RuntimeError(f"face_sums kernel vs plain: "
                           f"{int((sums != sums_p).sum())} sums differ")
    # the (face, 32 x 32 tile) partials the kernels merge
    valid = (keys >= 0) & (keys < mesh.n_faces)
    pix = torch.arange(keys.numel(), device=dev)
    tile = pix // w // 32 * -(-w // 32) + pix % w // 32
    pairs = torch.unique(keys[valid].long() * keys.numel() + tile[valid])
    per_face = torch.bincount(pairs // keys.numel(), minlength=mesh.n_faces)
    row = dict(max_abs_err=float((sums - sums_p).abs().max()),
               pixels=int(keys.numel()), faces_hit=int((counts[:, 0] > 0).sum()),
               longest_segment=int(torch.bincount(keys[valid].long()).max()),
               partials=int(pairs.numel()), most_partials=int(per_face.max()))
    # face_to_vert_texture's sum on the mesh: 3F vertex keys, a list
    faces_dev = torch.as_tensor(mesh.faces, dtype=torch.int64, device=dev)
    vkeys = faces_dev.reshape(-1)
    face_values = torch.as_tensor(rng.random((mesh.n_faces, n_classes), dtype=np.float32),
                                  device=dev)
    vvalues = face_values.repeat_interleave(3, dim=0).contiguous()
    vsums, vcounts = face_sums.face_sums(vkeys, vvalues, mesh.n_verts)
    vsums_p, vcounts_p = face_sums.face_sums_plain(vkeys, vvalues, mesh.n_verts)
    _sync(dev)
    if not (torch.equal(vsums, vsums_p) and torch.equal(vcounts, vcounts_p)):
        raise RuntimeError(f"face_sums kernel vs plain on the vertex keys: "
                           f"{int((vsums != vsums_p).sum())} sums differ")
    vertex = dict(keys=int(vkeys.numel()), verts=mesh.n_verts,
                  max_abs_err=float((vsums - vsums_p).abs().max()))
    if timing:
        seg = torch.where(valid, keys.long(), mesh.n_faces)
        zeros = torch.zeros((mesh.n_faces + 1, n_classes), device=dev)
        n_bytes = keys.numel() * 4 + values.numel() * 4 + 2 * sums.numel() * 4
        call = lambda: face_sums.face_sums(keys, values, mesh.n_faces, shape=shape)
        row.update(
            ms=_cuda_ms(call, runs=20),
            plain_ms=_cuda_ms(lambda: face_sums.face_sums_plain(
                keys, values, mesh.n_faces, shape)),
            library_ms=_cuda_ms(lambda: zeros.index_add(0, seg, values), runs=20),
            bound_ms=_bound(n_bytes, 0)[0], bound_by="bytes")
        # the wrapper's launches by name, device ms a call: no sort kernel
        row["busy"], row["launch_ms"] = _profile(call)
        sorts = [k for k in row["launch_ms"] if "sort" in k.lower()]
        if sorts:
            raise RuntimeError(f"face_sums launched a sort: {sorts}")
        vzeros = torch.zeros((mesh.n_verts, n_classes), device=dev)
        vbytes = vkeys.numel() * 8 + vvalues.numel() * 4 + 2 * vsums.numel() * 4
        vertex.update(
            ms=_cuda_ms(lambda: face_sums.face_sums(vkeys, vvalues, mesh.n_verts),
                        runs=20),
            plain_ms=_cuda_ms(lambda: face_sums.face_sums_plain(
                vkeys, vvalues, mesh.n_verts)),
            library_ms=_cuda_ms(lambda: vzeros.index_add(0, vkeys, vvalues), runs=20),
            bound_ms=_bound(vbytes, 0)[0])
    row["vertex"] = vertex
    _line("6m", views=views, runs_equal=True, launches=launches,
          kernel_equals_plain=True, **row, card=card)
    return launches, row


SPECIES = ("cedar", "fir", "oak", "pine")
ROUND_TRIP_MIN_AGREE = 0.99  # share of observed, labelled faces that come back


def _label_polygons(origin_xy, size, seed=0):
    """Six seeded star polygons in a 3 x 2 grid over the mesh's footprint
    (about half of it), each with one of four species names."""
    rng = np.random.default_rng(seed)
    polys, names = [], []
    for k in range(6):
        cx = (k % 3 - 1) * size / 3 + rng.uniform(-0.05, 0.05) * size
        cy = (k // 3 - 0.5) * size / 2 + rng.uniform(-0.05, 0.05) * size
        ang = np.sort(rng.uniform(0, 2 * np.pi, 9))
        radius = rng.uniform(0.17, 0.23, (9, 1)) * size
        ring = np.array([cx, cy]) + radius * np.stack([np.cos(ang), np.sin(ang)], 1)
        polys.append(Polygon(ring + np.asarray(origin_xy)))
        names.append(SPECIES[k % len(SPECIES)])
    return polys, names


def _survey_of(folder, n_views=None):
    """The files of a survey :func:`_write_survey` wrote into ``folder``
    (``n_views`` views, default the pipeline suite's)."""
    folder = Path(folder)
    names = [f"view_{k:02d}.png" for k in range(n_views or PIPELINE_VIEWS)]
    return dict(mesh_file=folder / "mesh.ply", cameras_file=folder / "cameras.xml",
                labels_file=folder / "labels.geojson", image_folder=folder / "images",
                render_folder=folder / "renders", names=names)


def _write_survey(folder, verts, faces, c2ws, sensors, sensor_ids, width, height,
                  size=4.0, lat=36.0, lon=-119.0, phase="5a"):
    """Phase 5a: the survey on disk.  The mesh as a binary PLY in its local
    frame, the cameras as a Metashape XML with a local -> ECEF transform,
    and seeded label polygons in UTM as GeoJSON; no image files."""
    folder = Path(folder)
    t0 = time.perf_counter()
    mesh_file = folder / "mesh.ply"
    save_mesh(mesh_file, verts, faces)
    _write_cameras(folder / "cameras.xml", c2ws, sensors, sensor_ids, width, height,
                   lat, lon)
    utm = crs_utils.utm_epsg_for(lat, lon)
    origin = crs_utils.transform_points(np.array([[lat, lon, 0.0]]), 4326, utm)[0]
    polys, species = _label_polygons(origin[:2], size)
    labels_file = folder / "labels.geojson"
    VectorData(polys, {"species": species}, epsg=utm).to_file(labels_file)
    survey = _survey_of(folder, len(c2ws))
    _line(phase, faces=int(len(faces)), views=len(c2ws), image=[height, width],
          mesh_bytes=mesh_file.stat().st_size, polygons=len(polys),
          species=sorted(set(species)), utm_epsg=utm,
          write_s=round(time.perf_counter() - t0, 3))
    return survey


def _write_cameras(path, c2ws, sensors, sensor_ids, width, height, lat=36.0,
                   lon=-119.0):
    """The cameras as a Metashape XML with a local -> ECEF transform, views
    named ``view_<k>.png`` (two digits, or three past 100 views)."""
    digits = 2 if len(c2ws) <= 100 else 3
    names = [f"view_{k:0{digits}d}.png" for k in range(len(c2ws))]
    order = sorted(sensors)
    Path(path).write_text(make_metashape_xml(
        c2ws, names, local_to_ecef_frame(lat, lon), 0.0, width, height,
        sensors=[{"f": sensors[k]["f"], "cx": sensors[k].get("cx", 0.0),
                  "cy": sensors[k].get("cy", 0.0),
                  "distortion": sensors[k].get("distortion_params")} for k in order],
        sensor_ids=[order.index(k) for k in sensor_ids]))


def _mask_of(p2f, face_tex):
    """The uint8 mask of a pix2face map, in numpy: the face's texture,
    NaN and background 255, clipped to 0..255."""
    tex = np.append(face_tex[:, 0], np.nan).astype(np.float32)
    data = tex[p2f]
    return np.clip(np.where(np.isfinite(data), data, 255.0), 0, 255).astype(np.uint8)


def _render_checked(survey, cfg, device=None):
    """Phase 5b: ``render_labels`` through the entry point (``device`` left
    at its default unless given), and every check of what it wrote.
    Returns (mesh, cameras, the entry point's launch counts, fields of
    the phase line)."""
    on = {} if device is None else {"device": device}
    _reset_launches()
    on_card = device is None or torch.device(device).type == "cuda"
    held_gb = None
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # what the earlier phases still hold on the card
        held_gb = round(torch.cuda.memory_allocated() / 1e9, 3)
    t0 = time.perf_counter()
    mesh, cams = render_labels(
        survey["mesh_file"], survey["cameras_file"], survey["image_folder"],
        texture=survey["labels_file"], texture_column_name="species",
        render_savefolder=survey["render_folder"], raster_config=cfg, **on)
    wall_s = time.perf_counter() - t0
    peak_mem_gb = round(torch.cuda.max_memory_allocated() / 1e9, 3) if on_card else None
    launches = {"raster_tiles": raster_tiles.launches, "s_raster": subtile.launches,
                "face_class_counts": face_counts.launches,
                "onehot_class": onehot.launches,
                "triangle_setup": tri_setup.launches, "tile_binning": binning.launches}
    n = len(survey["names"])
    want = {"raster_tiles": n if on_card else 0, "s_raster": 0,
            "face_class_counts": 0, "onehot_class": 0}
    if len(cams) != n or _back(launches) != want:
        raise RuntimeError(f"render_labels: {len(cams)} cameras of {n}, launches "
                           f"{launches}, expected {want}")
    _demand_front("render_labels", launches, n * on_card)
    files = sorted(p.name for p in survey["render_folder"].iterdir())
    if files != survey["names"]:
        raise RuntimeError(f"render_labels wrote {files}")
    overflow = sum(mesh.check_raster_capacity(cams, i) for i in range(n))
    if overflow:
        raise RuntimeError(f"render caps {cfg.caps} overflow ({overflow})")
    face_tex = mesh.get_texture(request_vertex_texture=False)
    h, w = cams.sensors[cams.sensor_IDs[0]]["image_height"], \
        cams.sensors[cams.sensor_IDs[0]]["image_width"]
    classes, file_bytes, p2f0 = [], [], None
    first_distorted = next(i for i in range(n)
                           if mesh._distortion_map_device(cams, i, 1.0) is not None)
    for i, name in enumerate(survey["names"]):
        path = survey["render_folder"] / name
        mask = read_image_or_numpy(path)
        if mask.shape != (h, w) or mask.dtype != np.uint8:
            raise RuntimeError(f"{name}: {mask.dtype} {mask.shape}")
        p2f = mesh.pix2face(cams, [i])[0]
        if i == 0:
            p2f0 = p2f
        if not np.array_equal(mask, _mask_of(p2f, face_tex)):
            raise RuntimeError(f"{name} is not its pix2face's mask")
        ids = np.unique(mask)
        if 255 not in ids or len(ids) < 3:
            raise RuntimeError(f"{name} holds only {ids.tolist()}")
        classes.append(ids[ids != 255].tolist())
        file_bytes.append(path.stat().st_size)
        # view 0 and the first distorted view (view 6 of the suite) again
        # through the plain versions: the plain raster, numpy's remap of
        # the downloaded pinhole pix2face with the same map, numpy's
        # texture lookup
        if i in (0, first_distorted):
            b = cams.get_camera_batch([i], device=mesh.device)
            setup = setup_from_soa(mesh._tri_soa_device(cams, cfg.bin_block),
                                   b.world_to_cam[0], b.f[0], w, h, cfg.znear)
            cand, counts = binned_face_lists(bin_triangles(setup, cfg, h, w), cfg)
            plain = raster_tiles.raster_tiles_plain(
                setup.planes.contiguous(), cand, counts, cfg, h, w).cpu().numpy()
            w2i = mesh._distortion_map_device(cams, i, 1.0)
            if w2i is not None:
                plain = remap_image(plain, w2i.cpu().numpy(), fill_value=-1,
                                    interpolation_order=0)
            if not np.array_equal(mask, _mask_of(plain, face_tex)):
                raise RuntimeError(
                    f"view {i}: the file differs from the plain re-run in "
                    f"{int((mask != _mask_of(plain, face_tex)).sum())} pixels")
    # the pix2face cache: the second call reads the file and renders nothing
    cache = survey["render_folder"].parent / "cache"
    first = mesh.pix2face(cams, [0], save_to_cache=True, cache_folder=cache)
    before = raster_tiles.launches
    again = mesh.pix2face(cams, [0], save_to_cache=True, cache_folder=cache)
    cache_files = sorted(cache.glob("pix2face_*.ggr"))
    if (raster_tiles.launches != before or len(cache_files) != 1
            or not np.array_equal(again, first) or not np.array_equal(first[0], p2f0)):
        raise RuntimeError("the pix2face cache did not serve view 0's map")
    fields = dict(
        views=n, faces=mesh.n_faces, wall_s=round(wall_s, 3), launches=launches,
        overflow=overflow, files_equal_pix2face_masks=True,
        plain_rerun_views=[0, first_distorted], plain_rerun_equal=True,
        cache_hit_equal=True,
        cache_file_bytes=cache_files[0].stat().st_size, classes=classes,
        labelled_vertex_share=round(float(np.isfinite(mesh.vertex_texture).mean()), 4),
        file_bytes=file_bytes, peak_mem_gb=peak_mem_gb,
        held_before_gb=held_gb)
    return mesh, cams, launches, fields


def _render_times(survey, mesh, cams, cfg):
    """Where a rendered view's time goes on the card, stage by stage (CUDA
    events for the device stages, ``perf_counter`` for the host ones;
    medians of 3), and the host steps of the entry point timed alone."""
    dev = mesh.device
    face_tex = mesh._on_device(mesh.get_texture(False), torch.float32)
    out = survey["render_folder"].parent / "timing"

    def host_ms(fn, runs=3):
        fn()
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def cast(img):
        data = torch.where(torch.isfinite(img[..., 0]), img[..., 0], 255.0)
        return data.clamp(0, 255).to(torch.uint8)

    rows = []
    for i in range(len(cams)):
        w2i = mesh._distortion_map_device(cams, i, 1.0)
        pinhole, _ = mesh._rasterize_view(cams, i, 1.0, False, cfg)
        p2f = pinhole if w2i is None else remap_image_torch(pinhole, w2i, -1)
        img = render_texture(p2f, face_tex)
        mask_dev = cast(img)
        mask = mask_dev.cpu().numpy()
        img_host = img.cpu().numpy()
        row = dict(
            view=i, distorted=w2i is not None,
            raster_chain_ms=_cuda_ms(
                lambda: mesh._rasterize_view(cams, i, 1.0, False, cfg), runs=3),
            remap_ms=None if w2i is None else _cuda_ms(
                lambda: remap_image_torch(pinhole, w2i, -1), runs=3),
            texture_gather_ms=_cuda_ms(lambda: render_texture(p2f, face_tex), runs=3),
            device_cast_ms=_cuda_ms(lambda: cast(img), runs=3),
            download_uint8_ms=host_ms(lambda: mask_dev.cpu()),
            # the other order: the float32 render down, the cast in numpy
            download_float32_ms=host_ms(lambda: img.cpu()),
            host_cast_ms=host_ms(lambda: np.clip(np.where(
                np.isfinite(img_host[..., 0]), img_host[..., 0], 255.0), 0, 255
            ).astype(np.uint8)),
        )
        for level in (1, 6):
            row[f"png_zlib{level}_ms"] = host_ms(
                lambda: write_image(out / f"l{level}.png", mask, level))
            row[f"png_zlib{level}_bytes"] = (out / f"l{level}.png").stat().st_size
        rows.append(row)
        _line("5b_view", **row)
    # the render loop alone, warm: what save_renders costs for the 8 views
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mesh.save_renders(cams, output_folder=out / "again")
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    # the entry point's host steps, each alone
    t0 = time.perf_counter()
    again = TexturedMesh(survey["mesh_file"], transform_filename=survey["cameras_file"],
                         device=dev)
    t1 = time.perf_counter()
    again.select_mesh_ROI(survey["labels_file"], 50.0, inplace=True)
    t2 = time.perf_counter()
    again.load_texture(survey["labels_file"], "species")
    t3 = time.perf_counter()
    again.get_texture(request_vertex_texture=False)
    t4 = time.perf_counter()
    return dict(render_loop_s=round(loop_s, 4),
                render_views_per_s=round(len(cams) / loop_s, 4),
                load_s=round(t1 - t0, 3), roi_s=round(t2 - t1, 3),
                texture_s=round(t3 - t2, 3), vert_to_face_s=round(t4 - t3, 3))


class _RouteLog(logging.Handler):
    """The port's log records: which path ``aggregate_projected_images``
    took and why, and when the planner's census ended."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []  # (time.time() of the record, message)

    def emit(self, record):
        self.records.append((record.created, record.getMessage()))


def _round_trip(survey, mesh, cfg, device=None, min_agree=ROUND_TRIP_MIN_AGREE):
    """Phase 5c: the rendered masks back onto the mesh through the
    ``aggregate_images`` entry point; of the faces observed and labelled,
    the share whose predicted class is the mesh's face texture."""
    on = {} if device is None else {"device": device}
    routes = _RouteLog()
    route_logger = logging.getLogger("geograypher_tpu_torch")
    level = route_logger.level
    route_logger.setLevel(logging.INFO)
    route_logger.addHandler(routes)
    t0 = time.time()
    pred, avg = aggregate_images(
        survey["mesh_file"], survey["cameras_file"],
        image_folder=survey["render_folder"], label_folder=survey["render_folder"],
        take_every_nth_camera=None, n_classes=len(mesh.IDs_to_labels),
        raster_config=cfg, **on)
    t_end = time.time()
    wall_s = t_end - t0
    route_logger.removeHandler(routes)
    route_logger.setLevel(level)
    truth = mesh.get_texture(request_vertex_texture=False)[:, 0]
    if pred.shape != truth.shape or avg.shape != (len(truth), len(mesh.IDs_to_labels)):
        raise RuntimeError(f"round trip: predictions {pred.shape}, faces {truth.shape}")
    both = np.isfinite(pred) & np.isfinite(truth)
    agree = float((pred[both] == truth[both]).mean())
    # a face without a label rendered as 255 everywhere: nothing to predict
    stray = int((np.isfinite(pred) & ~np.isfinite(truth)).sum())
    if agree < min_agree or both.mean() < 0.2:
        raise RuntimeError(f"round trip: {agree:.6f} of {int(both.sum())} observed, "
                           f"labelled faces came back (needs {min_agree})")
    route = [(t, m) for t, m in routes.records if "aggregate_projected_images" in m]
    # the log's clock splits the call: up to the route's decision (mesh and
    # cameras loaded, every view read and scanned), the census, the rest
    census = [t for t, m in routes.records if m.startswith("census buckets")]
    split = None
    if route and census:
        split = dict(to_route_s=round(route[-1][0] - t0, 3),
                     census_s=round(census[-1] - route[-1][0], 3),
                     runs_and_rest_s=round(t_end - census[-1], 3))
    return dict(route=route[-1][1] if route else None, wall_s=round(wall_s, 3),
                wall_split=split, faces=len(truth),
                observed_and_labelled=int(both.sum()),
                labelled=int(np.isfinite(truth).sum()), agree=agree,
                min_agree=min_agree, predicted_without_label=stray)


def _render_phase(folder, verts, faces, c2ws, sensors, sensor_ids, cfg, smi):
    """Phase 5: the render path from a survey on disk in ``folder``, and the
    round trip.  Returns (the survey, the kernels' launches on the two
    entry points)."""
    survey = _write_survey(folder, verts, faces, c2ws, sensors, sensor_ids, W, H)
    mesh, cams, launches, fields = _render_checked(survey, cfg)
    times = _render_times(survey, mesh, cams, cfg)
    _line("5b", **fields, **times, png_zlib_level=PNG_ZLIB_LEVEL, card=smi)
    _reset_launches()
    trip = _round_trip(survey, mesh, cfg)
    back = {"raster_tiles": raster_tiles.launches,
            "face_class_counts": face_counts.launches,
            "onehot_class": onehot.launches,
            "triangle_setup": tri_setup.launches, "tile_binning": binning.launches}
    if any(n != len(c2ws) for n in _back(back).values()):
        raise RuntimeError(f"round trip launches {back} for {len(c2ws)} views")
    _demand_front("round trip", back, len(c2ws))
    if "planned" not in (trip["route"] or ""):
        raise RuntimeError(f"round trip took no planned route: {trip['route']}")
    _line("5c", **trip, launches=back, card=smi)
    return survey, launches, back


PIPELINE_VIEWS = 20  # the bench suite's count (bench.py:166-198)


def _suite_sensor_ids(n_views):
    """The suite's lens models: the last quarter of the views through the
    Brown-Conrady sensors, each view at its focal (sensors of
    ``_bench_scene``)."""
    return [2 * (k >= n_views - n_views // 4) + (k % 2) for k in range(n_views)]


class _StatsLog(logging.Handler):
    """The ``pipeline_stats`` of the survey pipeline's log records."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.stats = []

    def emit(self, record):
        if hasattr(record, "pipeline_stats"):
            self.stats.append(record.pipeline_stats)


def _run_pipeline(mesh, cams, n_classes, log, **kwargs):
    """One ``aggregate_class_images_distributed`` call ended by a
    synchronise: ((fraction_sums, view_counts), seconds, launches,
    pipeline_stats)."""
    _reset_launches()
    out, sec = _timed(mesh.device, lambda: pipeline.aggregate_class_images_distributed(
        mesh, cams, n_classes, **kwargs))
    return out, sec, _launches(), log.stats[-1]


def _busy_share(fn):
    """``fn`` once more under ``torch.profiler``: (compute kernels' device
    ms over the window's ms, the copies' device ms, the window's ms), or
    Nones when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
    except RuntimeError:  # a card without profiler access: not measured
        return None, None, None
    wall_ms = start.elapsed_time(end)
    kernel_us = copy_us = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0) or 0
        if us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if "memcpy" in ev.key.lower() or "memset" in ev.key.lower():
            copy_us += us
        else:
            kernel_us += us
    if not kernel_us:
        return None, None, wall_ms
    return kernel_us / 1e3 / wall_ms, copy_us / 1e3, wall_ms


def _argmax_threads(images):
    """The default provider's host argmax (``nan_to_num`` + ``argmax``) of
    ``images`` in one thread and in one thread each: seconds of both,
    which say whether it releases the interpreter lock."""
    def scan(img):
        return np.argmax(np.nan_to_num(img), axis=-1)

    t0 = time.perf_counter()
    for img in images:
        scan(img)
    serial = time.perf_counter() - t0
    with concurrent.futures.ThreadPoolExecutor(len(images)) as pool:
        t0 = time.perf_counter()
        list(pool.map(scan, images))
        threads = time.perf_counter() - t0
    return serial, threads


def _pipeline_phase(mesh, cams, labels, n_classes, devices, card=None,
                    forced_caps=(16, 16, 16, 16), timing=True):
    """Phase 7: the survey pipeline (``parallel/pipeline.py``) on the
    planned phase's binning configuration and the library's default caps.

    With a provider of int class images on ``devices[0]`` (the main path):
    one launch per view and kernel, no retry, view counts exactly those of
    the planner's weighted path on the same labels and the fraction sums
    to ``PLANNED_MEAN_RTOL``; the same call again ``torch.equal``; the
    default provider (the host argmax of the one-hot images) equal to it;
    caps ``forced_caps`` gated and re-run to the same view counts; two
    shards on ``devices`` (one card twice: the cross-device sum) equal to
    one to f32 rounding.  Returns (the main run's launches, the fields of
    the phase line)."""
    dev = mesh.device
    n = len(cams)
    cfg = dataclasses.replace(DEFAULT_RASTER_CONFIG, bin_block=8, l0_window=(5, 2),
                              global_from=mesh.raster_config.global_from)
    seg = SegmentorCameraSet(cams, LabelSegmentor(labels, n_classes))
    log = _StatsLog()
    pipe_logger = logging.getLogger(pipeline.__name__)
    level = pipe_logger.level
    pipe_logger.setLevel(logging.INFO)
    pipe_logger.addHandler(log)
    try:
        tri_soa, params, host_labels, h, w, use_dist, _, _ = mesh._planned_inputs(
            cams, n_classes, None, 1.0, cfg, None, 4, None, labels)
        ref_sum, ref_count, plan = planner.aggregate_projected_planned(
            tri_soa, params, host_labels, cfg, h, w, tri_soa.shape[1], n_classes,
            use_dist=use_dist)
        ref_sum, ref_count = ref_sum[: mesh.n_faces], ref_count[: mesh.n_faces]
        one = devices[:1]
        base = dict(config=cfg, device_mesh=one)

        def provider(i):
            return labels[i]

        # the main path: int class images from a provider, one device
        # (its peak device memory, the plan included)
        on_card = torch.device(dev).type == "cuda"
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        (fr, vc), first_s, launches, first = _run_pipeline(
            mesh, cams, n_classes, log, class_image_provider=provider,
            prefetch_workers=4, **base)
        peak_gb = round(torch.cuda.max_memory_allocated() / 1e9, 3) if on_card else None
        k = int(torch.device(dev).type == "cuda")  # CPU tensors launch nothing
        want = {"raster_tiles": n * k, "face_class_counts": n * k, "s_raster": 0,
                "onehot_class": 0, "face_sums": 0}
        if _back(launches) != want or first["retried_views"]:
            raise RuntimeError(f"pipeline: launches {launches}, expected {want}, "
                               f"{first['retried_views']} views re-run")
        _demand_front("pipeline", launches, n * k)
        if fr.shape != (mesh.n_faces, n_classes) or not np.isfinite(fr).all():
            raise RuntimeError(f"pipeline: fraction sums {fr.shape}")
        if not np.array_equal(vc, ref_count):
            raise RuntimeError(f"pipeline: view counts differ from the planner's in "
                               f"{int((vc != ref_count).sum())} faces")
        rel = float(np.max(np.abs(fr - ref_sum) / np.maximum(np.abs(ref_sum), 1e-30)))
        if not np.allclose(fr, ref_sum, rtol=PLANNED_MEAN_RTOL, atol=1e-7):
            raise RuntimeError(f"pipeline: fraction sums off the planner's by {rel}")
        runs = {}
        for workers in (4, 1, 4, 1):  # turns: the rate at 4 and 1 workers
            (fr2, vc2), sec, _, st = _run_pipeline(
                mesh, cams, n_classes, log, class_image_provider=provider,
                prefetch_workers=workers, **base)
            if not (np.array_equal(fr2, fr) and np.array_equal(vc2, vc)):
                raise RuntimeError(f"pipeline: a second run at {workers} workers differs")
            runs.setdefault(workers, []).append((sec, st))
        onehot_runs = {}
        for workers in (1, 4):
            (fr3, vc3), sec, _, st = _run_pipeline(
                mesh, seg, n_classes, log, prefetch_workers=workers, **base)
            if not (np.array_equal(fr3, fr) and np.array_equal(vc3, vc)):
                raise RuntimeError("pipeline: the default one-hot provider differs from "
                                   "the int class images")
            onehot_runs[workers] = (sec, st)
        # caps every view overflows: gated, re-censused, re-run
        (fr4, vc4), forced_s, _, forced = _run_pipeline(
            mesh, cams, n_classes, log, class_image_provider=provider,
            device_mesh=one, auto_size_fold=False,
            config=dataclasses.replace(cfg, caps=tuple(forced_caps)))
        if (forced["retried_views"] < 1 or not np.array_equal(vc4, vc)
                or not np.allclose(fr4, fr, rtol=PLANNED_MEAN_RTOL, atol=1e-7)):
            raise RuntimeError(f"forced caps: {forced['retried_views']} views re-run, "
                               f"view counts equal {np.array_equal(vc4, vc)}")
        # two shards on one card: the cross-device sum's code path
        (fr5, vc5), two_s, two_launches, two = _run_pipeline(
            mesh, cams, n_classes, log, class_image_provider=provider, config=cfg,
            device_mesh=devices)
        two_rel = float(np.max(np.abs(fr5 - fr) / np.maximum(np.abs(fr), 1e-30)))
        if not np.array_equal(vc5, vc) or not np.allclose(fr5, fr, rtol=1e-6, atol=1e-7):
            raise RuntimeError(f"two shards against one: view counts equal "
                               f"{np.array_equal(vc5, vc)}, rel {two_rel}")
        busy = copy_ms = window_ms = argmax = None
        if timing and torch.device(dev).type == "cuda":
            busy, copy_ms, window_ms = _busy_share(
                lambda: pipeline.aggregate_class_images_distributed(
                    mesh, cams, n_classes, class_image_provider=provider, **base))
            argmax = _argmax_threads([seg.get_image_by_index(i) for i in range(4)])
    finally:
        pipe_logger.removeHandler(log)
        pipe_logger.setLevel(level)

    def rate(entries):
        return [round(n / sec, 4) for sec, _ in entries]

    def host(st):
        return {key: round(st[key], 4) for key in
                ("fetch_wait_s", "upload_s", "upload_wait_s", "plan_s", "seconds")}

    fields = dict(
        views=n, image=[h, w], faces=mesh.n_faces, classes=n_classes,
        devices=[str(d) for d in one], config=dict(
            bin_block=cfg.bin_block, l0_window=list(cfg.l0_window),
            caps_given=list(cfg.caps)),
        buckets=[dict(caps=list(b.config.caps), views=len(b.view_indices))
                 for b in plan.buckets],
        use_dist=use_dist, launches=launches, retried_views=first["retried_views"],
        first_s=round(first_s, 4), first_views_per_s=round(n / first_s, 4),
        first_host=host(first), peak_mem_gb=peak_gb, view_counts_equal_planner=True,
        fraction_sums_max_rel_err=rel, runs_equal=True,
        provider_views_per_s={w_: rate(runs[w_]) for w_ in (1, 4)},
        provider_host={w_: host(runs[w_][-1][1]) for w_ in (1, 4)},
        onehot_views_per_s={w_: round(n / onehot_runs[w_][0], 4) for w_ in (1, 4)},
        onehot_host={w_: host(onehot_runs[w_][1]) for w_ in (1, 4)},
        host_argmax_s=None if argmax is None else dict(
            views=4, one_thread=round(argmax[0], 4), four_threads=round(argmax[1], 4)),
        device_busy_share=None if busy is None else round(busy, 4),
        copy_device_ms=None if copy_ms is None else round(copy_ms, 3),
        profiled_window_ms=None if window_ms is None else round(window_ms, 3),
        forced_caps=list(forced_caps), forced_retried_views=forced["retried_views"],
        forced_s=round(forced_s, 4), forced_equal=True,
        two_shards=[str(d) for d in devices], two_shards_s=round(two_s, 4),
        two_shards_launches=two_launches, two_shards_max_rel_err=two_rel,
        two_shards_view_counts_equal=True, card=card)
    _line(7, **fields)
    return launches, fields


def _chunked_aggregate_check(mesh, seg, n_classes):
    """Phase 7c, part 1: ``aggregate_images_chunked`` over the pipeline's
    views (``seg``'s segmentor must find a view's labels in a subset of
    the cameras), two camera clusters each with a buffer over the scene:
    the view counts exactly the unchunked route's, the mean to
    ``PLANNED_MEAN_RTOL``.  Returns (the chunked run's launches, fields)."""
    dev = mesh.device
    cfg = dataclasses.replace(DEFAULT_RASTER_CONFIG, bin_block=8, l0_window=(5, 2),
                              global_from=mesh.raster_config.global_from)
    (avg, info), whole_s = _timed(dev, lambda: mesh.aggregate_projected_images(
        seg, config=cfg))
    _reset_launches()
    (c_avg, c_info), chunked_s = _timed(dev, lambda: chunked.aggregate_images_chunked(
        mesh, seg, n_clusters=2, buffer_meters=1e3, config=cfg))
    launches = _launches()
    counts, c_counts = info["projection_counts"], c_info["projection_counts"]
    if not np.array_equal(c_counts, counts):
        raise RuntimeError(f"chunked aggregation: view counts differ in "
                           f"{int((c_counts != counts).sum())} faces")
    seen = counts > 0
    rel = float(np.max(np.abs(c_avg[seen] - avg[seen])
                       / np.maximum(np.abs(avg[seen]), 1e-30)))
    if not np.allclose(c_avg, avg, rtol=PLANNED_MEAN_RTOL, atol=1e-7, equal_nan=True):
        raise RuntimeError(f"chunked aggregation: mean off the unchunked one by {rel}")
    clusters = chunked.cluster_cameras(seg, 2)
    return launches, dict(
        clusters=[len(c) for c in clusters], whole_route=("plan" in info),
        unchunked_s=round(whole_s, 4), chunked_s=round(chunked_s, 4),
        chunked_launches=launches, view_counts_equal=True, mean_max_rel_err=rel)


def _chunked_render_check(survey, cfg, device=None):
    """Phase 7c, part 2: ``render_labels(n_cameras_per_chunk=4)`` on phase
    5's survey on disk: every PNG equal to phase 5's unchunked one.
    Returns (its launches, fields)."""
    on = {} if device is None else {"device": device}
    out = survey["render_folder"].parent / "renders_chunked"
    _reset_launches()
    t0 = time.perf_counter()
    render_labels(survey["mesh_file"], survey["cameras_file"], survey["image_folder"],
                  texture=survey["labels_file"], texture_column_name="species",
                  render_savefolder=out, raster_config=cfg, n_cameras_per_chunk=4,
                  **on)
    wall_s = time.perf_counter() - t0
    launches = _launches()
    files = sorted(p.name for p in out.iterdir())
    if files != survey["names"]:
        raise RuntimeError(f"chunked render_labels wrote {files}")
    for name in files:
        if not np.array_equal(read_image_or_numpy(out / name),
                              read_image_or_numpy(survey["render_folder"] / name)):
            raise RuntimeError(f"chunked render: {name} differs from the unchunked mask")
    return launches, dict(render_files=len(files), render_files_equal=True,
                          render_wall_s=round(wall_s, 3), render_launches=launches)


def _sharded_check(mesh, cams, cfg, devices, n_classes):
    """Phase 7c, part 3: ``sharded_render_aggregate`` of a seeded per-face
    class texture over ``cams`` (pinhole), on ``devices[:1]`` and on
    ``devices``, against a loop of the mesh's raster chain +
    ``render_texture`` + ``project_image_to_faces``: view counts exactly,
    sums to f32 rounding.  Returns (the one-device run's launches,
    fields)."""
    dev = mesh.device
    h = cams.sensors[cams.sensor_IDs[0]]["image_height"]
    w = cams.sensors[cams.sensor_IDs[0]]["image_width"]
    soa = mesh._tri_soa_device(cams, cfg.bin_block)
    batch = cams.get_camera_batch(device=dev)
    setups = [setup_from_soa(soa, batch.world_to_cam[i], batch.f[i], w, h, cfg.znear)
              for i in range(len(cams))]
    census = torch.stack([bin_triangles(s, cfg, h, w, return_census=True)
                          for s in setups]).amax(0).tolist()
    cfg = dataclasses.replace(cfg, caps=tuple(int(math.ceil(c * CAP_MARGIN)) + 8
                                              for c in census))
    del setups
    tex = np.random.default_rng(7).integers(0, n_classes, (mesh.n_faces, 1)).astype(
        np.float32)
    tex_dev = torch.as_tensor(tex, device=dev)
    state = init_aggregation(mesh.n_faces, 1, dev)
    for i in range(len(cams)):
        p2f, over = mesh._rasterize_view(cams, i, 1.0, False, cfg)
        if int(over):
            raise RuntimeError(f"sharded check: view {i} overflows {cfg.caps}")
        state = accumulate_view(state, *project_image_to_faces(
            p2f, render_texture(p2f, tex_dev), mesh.n_faces))
    ref_sum, ref_count = state.value_sum.cpu().numpy(), state.view_count.cpu().numpy()
    tri = mesh.get_tri_verts_device(cams, 1)
    w2c = batch.world_to_cam.cpu().numpy()
    f = batch.f.cpu().numpy()
    out = {}
    for name, devs in (("one", devices[:1]), ("two", devices)):
        view_mesh = sharding.make_view_mesh(devs)
        shards = sharding.shard_views_for_mesh(w2c, f, view_mesh)
        _reset_launches()
        (vsum, vcount), sec = _timed(dev, lambda: sharding.sharded_render_aggregate(
            tri, tex, *shards, image_w=w, image_h=h, n_faces=mesh.n_faces,
            config=cfg, mesh=view_mesh))
        vsum, vcount = vsum.cpu().numpy(), vcount.cpu().numpy()
        rel = float(np.max(np.abs(vsum - ref_sum) / np.maximum(np.abs(ref_sum), 1e-30)))
        if not np.array_equal(vcount, ref_count) or not np.allclose(
                vsum, ref_sum, rtol=1e-6, atol=1e-7):
            raise RuntimeError(f"sharded_render_aggregate on {name} device(s): view "
                               f"counts equal {np.array_equal(vcount, ref_count)}, "
                               f"rel {rel}")
        seen = ref_count > 0
        if not np.allclose(vsum[seen, 0] / vcount[seen], tex[seen, 0], rtol=1e-6):
            raise RuntimeError("sharded_render_aggregate: a seen face's mean is not "
                               "its texture")
        out[name] = dict(devices=[str(d) for d in devs], seconds=round(sec, 4),
                         launches=_launches(), max_rel_err=rel,
                         bit_equal=bool(np.array_equal(vsum, ref_sum)))
    return out["one"]["launches"], dict(
        sharded_views=len(cams), sharded_caps=list(cfg.caps),
        sharded_seen_faces=int((ref_count > 0).sum()), sharded=out)


# -- phase 8: the detection workflow ---------------------------------------------

DETECTION_OBJECTS = 300
DETECTION_BOX_PX = 40.0  # side of a detection box and square
# the bench scene is 4 m wide and the nadir cameras fly ~2.1 m up: objects
# 0.1-0.4 m above the surface, at least 0.08 m apart, inside the part of
# the band the nadir views cover whose rays meet the floor covering mesh
DETECTION_HEIGHTS = (0.1, 0.4)
DETECTION_SPACING = 0.08
DETECTION_REGION = (-1.2, 1.2, -0.9, 0.9)  # x0, x1, y0, y1 (m)
# the triangulation: the similarity threshold (the detections are exact:
# two rays of one object meet within ~1e-5 m), the covering meshes' z
# buffer (the ceiling stays below every camera) and the recovery limit
DETECTION_THRESHOLD_M = 1e-4
DETECTION_Z_BUFFER = (0.5, -0.5)
DETECTION_RECOVER_M = 1e-3
# Louvain's resolution: two rays of different objects that pass within
# 1e-6 m weigh what true pairs weigh (the 1e-6 distance floor), and with
# 300 communities in one graph modularity merges two of them over one such
# edge at resolution 1 (the merge gain w / m - r S_a S_b / 2 m^2 turns
# negative only past r ~ 2.2); 10 keeps them apart and splits no object
DETECTION_RESOLUTION = 10.0


def _detection_objects(verts, faces, n, seed=8):
    """``n`` seeded points on the mesh surface (a random face, a random
    barycentric point) inside ``DETECTION_REGION``, at least
    ``DETECTION_SPACING`` apart, raised by ``DETECTION_HEIGHTS``."""
    rng = np.random.default_rng(seed)
    tri = np.asarray(verts)[np.asarray(faces)]
    cen = tri.mean(axis=1)
    x0, x1, y0, y1 = DETECTION_REGION
    inside = np.nonzero((cen[:, 0] >= x0) & (cen[:, 0] <= x1)
                        & (cen[:, 1] >= y0) & (cen[:, 1] <= y1))[0]
    pts = np.zeros((0, 3))
    for _ in range(200 * n):
        if len(pts) == n:
            break
        p = rng.dirichlet((1.0, 1.0, 1.0)) @ tri[inside[rng.integers(len(inside))]]
        if len(pts) and np.min(np.hypot(*(pts[:, :2] - p[:2]).T)) < DETECTION_SPACING:
            continue
        pts = np.vstack([pts, p])
    if len(pts) < n:
        raise RuntimeError(f"placed {len(pts)} of {n} detection objects")
    pts[:, 2] += rng.uniform(*DETECTION_HEIGHTS, n)
    return pts


def _write_detections(folder, cams, objects, w, h, box, device):
    """Every object that projects inside a view, in front of it (pinhole,
    as the workflow casts its rays): a ``box`` x ``box`` px box in the
    view's rows of one CSV and a square polygon in the view's GeoJSON.
    Detection k is row k of the CSV and the k-th polygon over the sorted
    GeoJSON files.  Returns (csv path, GeoJSON folder, (D,) view of each
    detection, (D,) object, (D, 2) centre (x, y))."""
    folder = Path(folder)
    regions = folder / "regions"
    regions.mkdir(parents=True, exist_ok=True)
    batch = cams.get_camera_batch(device=device)
    xy, _, valid = project_points(
        batch, torch.as_tensor(objects, dtype=torch.float32, device=device))
    xy, valid = xy.double().cpu().numpy(), valid.cpu().numpy()
    views, objs, centres = [], [], []
    half = box / 2.0
    csv_path = folder / "boxes.csv"
    with csv_path.open("w", newline="") as fh:
        out = csv.writer(fh)
        out.writerow(["image_path", "xmin", "ymin", "xmax", "ymax", "label"])
        for v in range(len(cams)):
            name = Path(cams.image_filenames[v]).name
            polys = []
            for k in np.nonzero(valid[v])[0]:
                x, y = xy[v, k]
                out.writerow([name, x - half, y - half, x + half, y + half,
                              f"object_{k}"])
                polys.append(Polygon(np.array([[x - half, y - half],
                                               [x + half, y - half],
                                               [x + half, y + half],
                                               [x - half, y + half]])))
                views.append(v)
                objs.append(k)
                centres.append((x, y))
            if polys:
                VectorData(polys, {"label": [f"object_{k}" for k in
                                             np.nonzero(valid[v])[0]]}).to_file(
                    regions / f"{Path(name).stem}.geojson")
    return (csv_path, regions, np.asarray(views), np.asarray(objs),
            np.asarray(centres).reshape(-1, 2))


def _csr_equal(a, b):
    a, b = a.tocsr(), b.tocsr()
    a.sort_indices()
    b.sort_indices()
    return (a.shape == b.shape and np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices) and np.array_equal(a.data, b.data))


def _detection_kernels_vs_plain(mesh, seg, cfg, w, h, timing):
    """Phase 8's kernels on view 0 of the detection survey (pinhole), at
    its own shape: the raster kernel against its plain version, then the
    counts kernel at (F, n_local), the view's own detections as the
    classes, bit for bit, with times, bound and ``torch.bincount``'s time
    at that shape."""
    dev = mesh.device
    batch = seg.get_camera_batch([0], device=dev)
    setup = setup_from_soa(mesh._tri_soa_device(seg, cfg.bin_block),
                           batch.world_to_cam[0], batch.f[0], w, h, cfg.znear)
    binned = bin_triangles(setup, cfg, h, w)
    cand, counts = binned_face_lists(binned, cfg)
    planes, bbox = setup.planes.contiguous(), setup.bbox
    p2f = raster_tiles.raster_tiles(planes, bbox, cand, counts, cfg, h, w)
    p2f_plain = raster_tiles.raster_tiles_plain(planes, cand, counts, cfg, h, w)
    if int(binned.overflow) or not torch.equal(p2f, p2f_plain):
        raise RuntimeError(f"detection view 0: overflow {int(binned.overflow)}, "
                           f"{int((p2f != p2f_plain).sum())} pixels off the plain raster")
    if not torch.equal(p2f, mesh._pix2face_device(seg, 0)):
        raise RuntimeError("detection view 0: the mesh's pix2face is not the raster's")
    img = torch.as_tensor(np.asarray(seg.get_image_by_index(0), np.float64), device=dev)
    local, classes = sparse.local_class_image(img)
    n_faces, n_local = mesh.n_faces, int(classes.numel())
    cnt = face_counts.face_class_counts(p2f, local, n_faces, n_local)
    cnt_plain = face_counts.face_class_counts_plain(p2f, local, n_faces, n_local)
    if not torch.equal(cnt, cnt_plain):
        raise RuntimeError(f"counts kernel vs plain at the detection shape ({n_faces}, "
                           f"{n_local}): max |diff| {int((cnt - cnt_plain).abs().max())}")
    bound_ms, bound_by = _bound(2 * h * w * 4 + n_faces * n_local * 4, 0)
    row = dict(classes=n_local, labelled_pixels=int((local >= 0).sum()),
               max_abs_err=int((cnt - cnt_plain).abs().max()),
               raster_max_abs_err=int((p2f - p2f_plain).abs().max()),
               bound_ms=bound_ms, bound_by=bound_by)
    del cnt, cnt_plain
    if timing:
        # background faces and unlabelled pixels shifted into their own bins
        key = ((p2f.long() + 1) * (n_local + 1) + local.long() + 1).reshape(-1)
        row.update(
            ms=_cuda_ms(lambda: face_counts.face_class_counts(p2f, local, n_faces,
                                                              n_local), runs=10),
            plain_ms=_cuda_ms(lambda: face_counts.face_class_counts_plain(
                p2f, local, n_faces, n_local), runs=3),
            library_ms=_cuda_ms(lambda: torch.bincount(
                key, minlength=(n_faces + 1) * (n_local + 1)), runs=10),
            nonzero_ms=_cuda_ms(lambda: torch.nonzero(
                face_counts.face_class_counts(p2f, local, n_faces, n_local)), runs=5),
            raster_ms=_cuda_ms(lambda: raster_tiles.raster_tiles(
                planes, bbox, cand, counts, cfg, h, w)))
        del key
    return row


def _plain_index_run(mesh, seg, n, centres_by_view, **kwargs):
    """The sparse counts of every view again, through the plain raster and
    the plain counts (no kernel may launch), and each view's pix2face at
    the given detection centres; ``kwargs`` go to
    ``aggregate_index_predictions``.  Returns (CSR, {view: faces at
    centres})."""
    import geograypher_tpu_torch.ops.rasterize as rasterize_mod

    kernel_raster, kernel_counts = rasterize_mod.raster_tiles, sparse.face_class_counts
    kernel_setup, kernel_binning = rasterize_mod.triangle_setup, rasterize_mod.tile_binning
    pix2face_device = mesh._pix2face_device
    at_centres = {}

    def plain_raster(planes, bbox, cand, counts, cfg, h, w, s_init=None):
        return raster_tiles.raster_tiles_plain(planes, cand, counts, cfg, h, w,
                                               s_init=s_init)

    def recording(cameras, index, **kw):
        p2f = pix2face_device(cameras, index, **kw)
        xy = centres_by_view.get(index)
        if xy is not None:
            at_centres[index] = p2f[torch.as_tensor(xy[:, 1].astype(np.int64)),
                                    torch.as_tensor(xy[:, 0].astype(np.int64))].cpu().numpy()
        return p2f

    rasterize_mod.raster_tiles = plain_raster
    rasterize_mod.triangle_setup = tri_setup.setup_from_soa_plain
    rasterize_mod.tile_binning = binning.bin_triangles_plain
    sparse.face_class_counts = face_counts.face_class_counts_plain
    mesh._pix2face_device = recording
    _reset_launches()
    try:
        counts, _ = sparse.aggregate_index_predictions(mesh, seg, n, **kwargs)
    finally:
        rasterize_mod.raster_tiles, sparse.face_class_counts = kernel_raster, kernel_counts
        rasterize_mod.triangle_setup, rasterize_mod.tile_binning = (kernel_setup,
                                                                    kernel_binning)
        del mesh._pix2face_device
    if any(_launches().values()):
        raise RuntimeError(f"the plain detection run launched {_launches()}")
    return counts, at_centres


def _triangulated(out_dir):
    """The local community points and ray communities of a run's
    ``communities.npz``."""
    comm = np.load(Path(out_dir) / "communities.npz")
    return comm["community_points"], comm["ray_IDs"]


def _detection_phase(folder, verts, faces, c2ws, sensors, sensor_ids, cfg, w=W, h=H,
                     n_objects=DETECTION_OBJECTS, box=DETECTION_BOX_PX, device=None,
                     card=None, timing=True):
    """Phase 8: the detection workflow from a survey on disk.  ``"8a"``
    writes the mesh, the cameras and ~``n_objects`` seeded objects'
    detections (a CSV of boxes, a GeoJSON of squares a view);
    ``project_detections`` at ``aggregate_image_scale=1.0`` (the main
    path of the raster and counts kernels: one launch a view each) must
    match a run of the same views through the plain versions exactly, and
    every detection whose centre pixel sees the mesh has counts;
    ``multiview_detections`` (covering mesh N=50) must recover every
    object seen in two or more views within ``DETECTION_RECOVER_M`` with
    no community farther than that from every object, give the same
    points twice and again from its cache files.  ``device`` None runs
    both entry points at their default (the card).  Returns (the
    kernels' launches on ``project_detections``, the counts kernel's row
    at the detection shape)."""
    on = {} if device is None else {"device": device}
    dev = torch.device("cuda" if device is None else device)
    folder = Path(folder) / "detections"
    survey = _write_survey(folder, verts, faces, c2ws, sensors, sensor_ids, w, h,
                           phase="8a")
    cams = MetashapeCameraSet(survey["cameras_file"], survey["image_folder"])
    mesh = TexturedMesh(survey["mesh_file"], transform_filename=survey["cameras_file"],
                        raster_config=cfg, device=dev)
    objects = _detection_objects(mesh.get_verts_in_local_frame(cams), mesh.faces,
                                 n_objects)
    csv_path, regions, det_view, det_obj, det_xy = _write_detections(
        folder, cams, objects, w, h, box, dev)
    n_det = len(det_view)
    per_view = np.bincount(det_view, minlength=len(cams))

    # project_detections: the main path of the raster and counts kernels
    stats = {}
    _reset_launches()
    _sync(dev)
    t0 = time.perf_counter()
    counts, vd = project_detections(
        survey["mesh_file"], survey["cameras_file"], survey["image_folder"],
        detections_folder=csv_path, image_shape=(h, w), aggregate_image_scale=1.0,
        projections_to_mesh_savefile=folder / "counts.npz",
        projections_to_geospatial_savefile=folder / "detections.geojson",
        raster_config=cfg, stats=stats, **on)
    _sync(dev)
    project_s = time.perf_counter() - t0
    launches = _launches()
    on_card = dev.type == "cuda"
    want = {"raster_tiles": len(cams) * on_card, "face_class_counts": len(cams) * on_card,
            "s_raster": 0, "onehot_class": 0, "face_sums": 0}
    if _back(launches) != want:
        raise RuntimeError(f"project_detections launches {launches}, expected {want}")
    _demand_front("project_detections", launches, len(cams) * on_card)
    saved = scipy.sparse.load_npz(folder / "counts.npz")
    if saved.shape != (mesh.n_faces, n_det) or not _csr_equal(saved, counts):
        raise RuntimeError(f"project_detections saved {saved.shape}, {n_det} detections")
    seg = SegmentorCameraSet(cams, TabularRectangleSegmentor(csv_path, image_shape=(h, w)))
    kernel_row = _detection_kernels_vs_plain(mesh, seg, cfg, w, h, timing)
    centres = {v: det_xy[det_view == v] for v in range(len(cams))}
    plain, at_centres = _plain_index_run(mesh, seg, n_det, centres)
    if not _csr_equal(plain, counts):
        raise RuntimeError("project_detections counts differ from the plain run's")
    column_nnz = np.diff(counts.tocsc().indptr)
    sees_mesh = np.concatenate([at_centres[v] >= 0 for v in range(len(cams))])
    empty = np.nonzero(sees_mesh & (column_nnz == 0))[0]
    if len(empty):
        raise RuntimeError(f"{len(empty)} detections over the mesh have no counts, "
                           f"e.g. {empty[:5].tolist()}")
    if len(vd) == 0 or "detection_label" not in vd.attributes:
        raise RuntimeError("project_detections exported no labelled polygons")

    # multiview_detections: twice from nothing, once from the cache files
    tri = {}
    for run, out_dir in (("first", "tri_a"), ("second", "tri_b"), ("cached", "tri_a")):
        st = {}
        _sync(dev)
        t0 = time.perf_counter()
        pts = multiview_detections(
            survey["mesh_file"], survey["cameras_file"], survey["image_folder"],
            detections_folder=regions, similarity_threshold_meters=DETECTION_THRESHOLD_M,
            louvain_resolution=DETECTION_RESOLUTION,
            covering_z_buffer=DETECTION_Z_BUFFER, out_dir=folder / out_dir,
            triangulated_points_savefile=folder / f"points_{run}.geojson",
            stats=st, **on)
        _sync(dev)
        tri[run] = (pts, time.perf_counter() - t0, st)
    first = tri["first"][0]
    if not (np.array_equal(first, tri["second"][0]) and np.array_equal(first, tri["cached"][0])):
        raise RuntimeError("multiview_detections: runs or the cached run differ")
    points, _ = _triangulated(folder / "tri_a")
    # objects with two or more rays that the covering meshes keep: the
    # detections' rays unclipped, in detection order, then the clip
    top, bottom = mesh.export_covering_meshes(
        N=50, z_buffer=DETECTION_Z_BUFFER,
        frame_transform=cams.get_local_to_epsg_4978_transform())
    rays = cams.calc_line_segments(RegionDetectionSegmentor(regions),
                                   ray_length_local=200.0, device=dev)
    _, _, kept = clip_line_segments(rays["ray_starts"], rays["ray_ends"],
                                    top[0][top[1]], bottom[0][bottom[1]], device=dev)
    seen2 = np.bincount(det_obj[kept], minlength=n_objects) >= 2
    d = np.linalg.norm(points[:, None, :] - objects[None], axis=2)
    to_object = d.min(axis=1) if len(points) else np.zeros(0)
    to_community = d.min(axis=0) if len(points) else np.full(n_objects, np.inf)
    missed = np.nonzero(seen2 & (to_community > DETECTION_RECOVER_M))[0]
    stray = np.nonzero(to_object > DETECTION_RECOVER_M)[0]
    if len(missed) or len(stray):
        raise RuntimeError(f"triangulation: {len(missed)} objects seen twice not "
                           f"recovered, {len(stray)} communities away from every object "
                           f"(limit {DETECTION_RECOVER_M} m)")
    written = VectorData.read_file(folder / "points_first.geojson")
    if len(written) != len(first) or "altitude" not in written.attributes:
        raise RuntimeError("multiview_detections wrote no points file")
    segs = np.load(folder / "tri_a" / "line_segments.npz")
    edges = json.loads((folder / "tri_a" / "edge_weights.json").read_text())

    def view_stage(key):
        vals = [s[key] for s in stats["views"]]
        return dict(median=round(statistics.median(vals) * 1e3, 4),
                    max=round(max(vals) * 1e3, 4)) if vals else None

    _line("8b", views=len(cams), objects=n_objects, detections=n_det,
          detections_per_view=[int(per_view.min()), round(float(per_view.mean()), 2),
                               int(per_view.max())],
          wall_s=round(project_s, 4), nnz=int(counts.nnz),
          polygons=len(vd), launches=launches, plain_run_equal=True,
          detections_over_the_mesh=int(sees_mesh.sum()),
          stages_s={k: round(stats[k], 4) for k in (
              "load_s", "aggregate_s", "export_s", "write_s")},
          view_ms={k: view_stage(k) for k in (
              "segment_s", "upload_s", "remap_s", "pix2face_s", "counts_s",
              "nonzero_s", "download_s", "host_s")},
          counts_kernel=kernel_row, card=card)
    _line("8c", rays=int(len(segs["ray_IDs"])), rays_cast=int(len(kept)), edges=len(edges),
          communities=int(len(points)), objects_seen_twice=int(seen2.sum()),
          max_recover_m=float(to_community[seen2].max()) if seen2.any() else None,
          max_community_to_object_m=float(to_object.max()) if len(points) else None,
          threshold_m=DETECTION_THRESHOLD_M, recover_limit_m=DETECTION_RECOVER_M,
          louvain_resolution=DETECTION_RESOLUTION,
          runs_equal=True, wall_s={k: round(v[1], 4) for k, v in tri.items()},
          stages_s={k: round(v, 4) for k, v in tri["first"][2].items()},
          second_stages_s={k: round(v, 4) for k, v in tri["second"][2].items()},
          card=card)
    return launches, kernel_row


# -- phase 9: GeoTIFF and DTM, the orthographic raster, polygon labelling ------------

DTM_SIZE = 4096  # px a side: 64 MB of float32
DTM_TILE = (256, 256)
DTM_PAD_M = 0.2  # the DTM's margin around the mesh footprint
# the DTM lies HAG_BASE + HAG_SLOPE * x below the grid's surface (local x, m)
HAG_BASE, HAG_SLOPE = 0.05, 0.025
HEIGHT_THRESHOLDS = (0.05, 0.09)  # render_height_masks: low, canopy
GROUND_THRESHOLD = 0.02  # aggregate_images' DTM ground relabel
HEIGHT_MARGIN = 0.01  # faces this far from every threshold keep their class
HEIGHT_CLASSES = {0: "flat", 1: "low", 2: "canopy"}
ORTHO_RES_M = 0.0016  # ~2500 px over the 4 m scene, ~6 px a face
ORTHO_TILED_MAX_PIXELS = 1024  # the same footprint in 3 x 3 tiles
ORTHO_BIG_RES_M = 0.0004  # ~10000 px: 2 x 2 tiles of ~5000 px
GROUND_VOTING_WEIGHT = 0.01
# knife-edge holes (a background pixel among faces: its centre on a shared
# edge both faces' float32 edge functions reject) allowed in an ortho map,
# each one also in the plain version's map
HOLE_MAX_SHARE = 1e-6
ORTHO_ORACLE_PX = 48  # a side of an ortho window held against the float64 oracle


def _surface(x, y):
    """The bench grid's height field (``_bench_scene``)."""
    return 0.1 * np.sin(3 * x) * np.cos(3 * y)


def _hag_truth(x):
    """The analytic height of the grid's surface above the DTM."""
    return HAG_BASE + HAG_SLOPE * x


def _write_dtm(path, mesh, local):
    """A DTM_SIZE^2 float32 GeoTIFF (deflate, tiled) over the mesh's
    footprint in its working UTM CRS, ``_hag_truth`` below the surface.
    The survey's local frame is tilted against the ellipsoid's normal, so
    an affine map from local (x, y, z) to (easting, northing, altitude),
    fitted on the vertices (``local``; residual returned), places the
    surface: each pixel centre's local (x, y) by a fixed-point iteration
    on the height field, its altitude less the offset there.  Returns
    (pixel size in m, the fit's largest residual in m, write seconds)."""
    utm = mesh.get_working_projected_CRS()
    uv = mesh.get_vertices_in_CRS(utm)[:, :2]
    alt = crs_utils.transform_points(mesh.verts, mesh.CRS, 4326)[:, 2]
    x0, y0 = uv.min(axis=0) - DTM_PAD_M
    x1, y1 = uv.max(axis=0) + DTM_PAD_M
    res = max(x1 - x0, y1 - y0) / DTM_SIZE
    world = np.concatenate([uv - np.array([x0, y1]), alt[:, None]], axis=1)
    homog = np.concatenate([local, np.ones((len(local), 1))], axis=1)
    fit, *_ = np.linalg.lstsq(homog[::17], world[::17], rcond=None)  # (4, 3)
    residual = float(np.abs(homog @ fit - world).max())
    inv_xy = np.linalg.inv(fit[:2, :2])
    cols = (np.arange(DTM_SIZE) + 0.5) * res
    heights = np.empty((DTM_SIZE, DTM_SIZE), np.float32)
    for r0 in range(0, DTM_SIZE, 512):
        rows = -(np.arange(r0, min(r0 + 512, DTM_SIZE)) + 0.5) * res
        east = np.broadcast_to(cols[None, :], (len(rows), DTM_SIZE)) - fit[3, 0]
        north = np.broadcast_to(rows[:, None], (len(rows), DTM_SIZE)) - fit[3, 1]
        z = np.zeros_like(east)
        for _ in range(5):  # contracts by the tilt times the slope, ~1e-3
            ex, ny = east - z * fit[2, 0], north - z * fit[2, 1]
            lx = ex * inv_xy[0, 0] + ny * inv_xy[1, 0]
            ly = ex * inv_xy[0, 1] + ny * inv_xy[1, 1]
            z = _surface(lx, ly)
        surface_alt = lx * fit[0, 2] + ly * fit[1, 2] + z * fit[2, 2] + fit[3, 2]
        heights[r0:r0 + len(rows)] = surface_alt - _hag_truth(lx)
    t0 = time.perf_counter()
    write_geotiff(path, Raster(heights, (res, 0.0, x0, 0.0, -res, y1), utm),
                  compression="deflate", tile=DTM_TILE)
    return res, residual, time.perf_counter() - t0


def _dtm_phase(folder, survey, verts, cfg, dev, card=None):
    """Phase 9a: a DTM under the survey of phase 8, its heights above
    ground against the analytic ones, ``render_height_masks`` (PNG masks of
    every view, float renders of every 5th) and ``aggregate_images`` with
    the DTM's ground relabel on the planned route.  Returns (the mesh,
    the DTM file, the kernels' launches)."""
    folder = Path(folder)
    on = {} if dev.type == "cuda" else {"device": dev}  # the card: the default
    on_card = dev.type == "cuda"
    mesh = TexturedMesh(survey["mesh_file"], transform_filename=survey["cameras_file"],
                        raster_config=cfg, device=dev)
    dtm = folder / "dtm.tif"
    res, residual, write_s = _write_dtm(dtm, mesh, verts)
    t0 = time.perf_counter()
    raster = read_geotiff(dtm)
    read_s = time.perf_counter() - t0
    if raster.data.shape != (DTM_SIZE, DTM_SIZE) or raster.epsg != mesh.get_working_projected_CRS():
        raise RuntimeError(f"DTM read back as {raster.data.shape}, EPSG {raster.epsg}")
    t0 = time.perf_counter()
    hag = mesh.get_height_above_ground(dtm)
    hag_s = time.perf_counter() - t0
    # nearest sampling: the surface's altitude less the offset moves by at
    # most its slope (the height field's, the offset's and 0.01 for the
    # frame's tilt and scale) times half a pixel's diagonal, plus the fit's
    # residual (the earth's curvature over 3 m, ~1e-6 m)
    slope = math.hypot(0.3 + HAG_SLOPE, 0.3) + 0.01
    tolerance = slope * res * math.sqrt(2) / 2 + residual + 1e-5
    hag_err = float(np.abs(hag - _hag_truth(verts[:, 0])).max())
    if not np.isfinite(hag).all() or hag_err > tolerance:
        raise RuntimeError(f"height above ground off the analytic one by {hag_err} m "
                           f"(tolerance {tolerance})")

    # render_height_masks: uint8 masks of every view, float renders of every 5th
    out = {}
    _reset_launches()
    for kind, kw in (("png", {}), ("npy", dict(binary_masks=False, take_every_nth_camera=5))):
        _sync(dev)
        t0 = time.perf_counter()
        render_height_masks(survey["mesh_file"], survey["cameras_file"],
                            survey["image_folder"], dtm, folder / f"heights_{kind}",
                            ground_threshold=HEIGHT_THRESHOLDS[0],
                            canopy_threshold=HEIGHT_THRESHOLDS[1], raster_config=cfg,
                            **on, **kw)
        _sync(dev)
        out[kind] = time.perf_counter() - t0
    launches = _launches()
    n_views = len(survey["names"])
    n_float = len(range(0, n_views, 5))
    if launches["raster_tiles"] != (n_views + n_float) * on_card:
        raise RuntimeError(f"render_height_masks launches {launches} for "
                           f"{n_views} + {n_float} views")
    _demand_front("render_height_masks", launches, (n_views + n_float) * on_card)
    # each mask against its view's float render: equal to the render
    # thresholded but where a face's vertices straddle a threshold (the
    # mask's face takes its vertices' majority class, the float render their
    # mean height), so only within the widest face's height spread of one
    spread = float(np.ptp(hag[mesh.faces], axis=1).max()) + 1e-6
    mismatched = checked = 0
    for k in range(0, n_views, 5):
        name = Path(survey["names"][k]).stem
        mask = read_image_or_numpy(folder / "heights_png" / f"{name}.png")
        height = np.load(folder / "heights_npy" / f"{name}.npy")
        seen = np.isfinite(height)
        if mask.shape != height.shape or not np.array_equal(mask == 255, ~seen):
            raise RuntimeError(f"view {k}: mask and float render see different pixels")
        want = ((height >= HEIGHT_THRESHOLDS[0]).astype(np.uint8)
                + (height >= HEIGHT_THRESHOLDS[1]))
        off = seen & (mask != want)
        near = np.min([np.abs(height - t) for t in HEIGHT_THRESHOLDS], axis=0)
        if (near[off] > spread).any():
            raise RuntimeError(f"view {k}: {int((near[off] > spread).sum())} mask pixels "
                               "differ from the thresholded float render off a threshold")
        mismatched += int(off.sum())
        checked += int(seen.sum())
    classes_seen = sorted(int(c) for c in np.unique(read_image_or_numpy(
        folder / "heights_png" / survey["names"][0])))

    # aggregate_images on the masks, with the DTM's ground relabel
    _reset_launches()
    routes = _RouteLog()
    route_logger = logging.getLogger("geograypher_tpu_torch")
    level = route_logger.level
    route_logger.setLevel(logging.INFO)
    route_logger.addHandler(routes)
    _sync(dev)
    t0 = time.perf_counter()
    pred, avg = aggregate_images(
        survey["mesh_file"], survey["cameras_file"], image_folder=folder / "heights_png",
        label_folder=folder / "heights_png", take_every_nth_camera=None,
        n_classes=len(HEIGHT_CLASSES), IDs_to_labels=HEIGHT_CLASSES, DTM_file=dtm,
        height_above_ground_threshold=GROUND_THRESHOLD, raster_config=cfg, **on)
    _sync(dev)
    agg_s = time.perf_counter() - t0
    route_logger.removeHandler(routes)
    route_logger.setLevel(level)
    agg_launches = _launches()
    route = [m for _, m in routes.records if "aggregate_projected_images" in m]
    if not route or "planned" not in route[-1]:
        raise RuntimeError(f"aggregate_images with a DTM took no planned route: {route}")
    if any(agg_launches[k] != n_views * on_card
           for k in ("raster_tiles", "face_class_counts", "onehot_class")):
        raise RuntimeError(f"aggregate_images launches {agg_launches} for {n_views} views")
    _demand_front("aggregate_images (DTM)", agg_launches, n_views * on_card)
    truth = np.zeros(len(hag))
    truth[hag >= HEIGHT_THRESHOLDS[0]] = 1
    truth[hag >= HEIGHT_THRESHOLDS[1]] = 2
    # a face's class in the masks: its vertices' majority (ties to the
    # lowest class, as vert_to_face_discrete breaks them)
    votes = truth[mesh.faces].astype(int)
    face_class = np.stack([(votes == c).sum(axis=1) for c in range(3)], axis=1).argmax(axis=1)
    low = (hag[mesh.faces] < GROUND_THRESHOLD).all(axis=1)
    # the classes come back through vertices (faces -> vertices -> the
    # relabel -> faces), which blends them along class borders: held on the
    # faces whose vertices all lie HEIGHT_MARGIN or more from every threshold
    near = np.min([np.abs(hag - t) for t in HEIGHT_THRESHOLDS + (GROUND_THRESHOLD,)],
                  axis=0)
    interior = (near[mesh.faces] >= HEIGHT_MARGIN).all(axis=1) & ~low
    seen = np.isfinite(pred)
    ground_id = len(HEIGHT_CLASSES)
    if not (pred[seen & low] == ground_id).all() or not (seen & low).any():
        raise RuntimeError(f"DTM relabel: {int((pred[seen & low] != ground_id).sum())} of "
                           f"{int((seen & low).sum())} faces below {GROUND_THRESHOLD} m "
                           "not ground")
    agree = float((pred[seen & interior] == face_class[seen & interior]).mean())
    if agree < ROUND_TRIP_MIN_AGREE:
        raise RuntimeError(f"aggregate_images with a DTM: {agree} of the faces above "
                           "ground came back")
    high = seen & ~low
    agree_all = float((pred[high] == face_class[high]).mean())
    del face_class, votes
    for k, v in agg_launches.items():
        launches[k] += v
    _line("9a", dtm_px=DTM_SIZE, dtm_tile=list(DTM_TILE), dtm_res_m=res,
          dtm_bytes=dtm.stat().st_size, dtm_write_s=round(write_s, 4),
          dtm_read_s=round(read_s, 4), fit_residual_m=residual,
          hag_s=round(hag_s, 4), hag_max_err_m=hag_err, hag_tolerance_m=tolerance,
          height_masks_s=round(out["png"], 4), height_renders_s=round(out["npy"], 4),
          masks_per_s=round(n_views / out["png"], 4), mask_classes=classes_seen,
          mask_pixels_off_threshold=mismatched, mask_pixels_checked=checked,
          face_spread_m=spread, aggregate_s=round(agg_s, 4), route=route[-1],
          faces_seen=int(seen.sum()), ground_faces=int((seen & low).sum()),
          interior_faces=int((seen & interior).sum()), interior_agree=agree,
          above_ground_agree=agree_all, launches=launches, card=card)
    return mesh, dtm, launches


def _ortho_caps(mesh, plan):
    """Caps from the census of every tile of an orthographic plan, by the
    planner's rule (``census_caps``)."""
    census = mesh.ortho_raster_census(plan, RasterConfig())
    return census, census_caps(census, RasterConfig()).caps


def _hole_mask(p2f):
    """Background pixels whose four neighbours all see a face: a pixel
    centre on a shared edge that both faces' float32 edge functions
    reject (they are not exact negations of each other)."""
    p = torch.as_tensor(p2f)
    holes = torch.zeros_like(p, dtype=torch.bool)
    inner = p[1:-1, 1:-1] < 0
    for sl in ((slice(None, -2), slice(1, -1)), (slice(2, None), slice(1, -1)),
               (slice(1, -1), slice(None, -2)), (slice(1, -1), slice(2, None))):
        inner &= p[sl] >= 0
    holes[1:-1, 1:-1] = inner
    return holes


def _ortho_kernel_vs_plain(plan, cfg, k=0, timed=True):
    """The raster kernel against its plain version on tile ``k`` of an
    orthographic plan, bit for bit; both timed (``timed``), with the
    bound."""
    i0, j0, w2c = plan.tiles[k]
    h, w = plan.tile_h, plan.tile_w
    setup = setup_triangles(transform_to_camera(plan.tri, w2c), plan.focal, w, h,
                            cfg.znear)
    binned = bin_triangles(setup, cfg, h, w)
    if int(binned.overflow):
        raise RuntimeError(f"ortho tile {k}: caps {cfg.caps} overflow")
    cand, counts = binned_face_lists(binned, cfg)
    planes, bbox = setup.planes.contiguous(), setup.bbox
    p2f = raster_tiles.raster_tiles(planes, bbox, cand, counts, cfg, h, w)
    plain = raster_tiles.raster_tiles_plain(planes, cand, counts, cfg, h, w)
    _sync(plain.device)
    if not torch.equal(p2f, plain):
        agree, bg = _knife_edge(p2f, plain)
        raise RuntimeError(f"ortho tile {k} ({h}x{w}): kernel vs plain "
                           f"{int((p2f != plain).sum())} pixels differ ({bg} face vs "
                           "background)")
    (bound_ms, bound_by), need, cand_px, _ = _raster_bound(
        setup, planes, cand, counts, cfg, h=h, w=w)
    timed = timed and planes.device.type == "cuda"  # CUDA events: on the card only
    row = dict(shape=[h, w], focal=plan.focal, max_abs_err=0,
               ms=_cuda_ms(lambda: raster_tiles.raster_tiles(
                   planes, bbox, cand, counts, cfg, h, w)) if timed else None,
               plain_ms=_cuda_ms(lambda: raster_tiles.raster_tiles_plain(
                   planes, cand, counts, cfg, h, w), runs=3) if timed else None,
               bound_ms=bound_ms, bound_by=bound_by, need_pixels=need,
               cand_pixels=cand_px, list_entries=[int(c.sum()) for c in counts])
    return p2f, row


def _ortho_oracle(plan, p2f, centres, size=ORTHO_ORACLE_PX):
    """Windows of an orthographic map against the float64 brute-force
    oracle at the plan's own focal length (~1e5): the depth planes and the
    cull margin at that scale.  A window of ``size`` px a side around each
    (row, column) of ``centres``, cut to the pasted part of its tile, is
    rendered by that tile's camera from the same float32 triangles and
    matrix; only the faces whose projected box meets the window go to the
    oracle, its principal point moved so that they land where the tile
    puts them.  Returns (agreement, the smallest window's agreement, the
    face-vs-background pixels as (row, column, map, oracle))."""
    tri = plan.tri.cpu().numpy().astype(np.float64)
    cams = {}
    same = total = 0
    worst, background = 1.0, []
    for r, c in centres:
        k = next(k for k, (i0, j0, _) in enumerate(plan.tiles)
                 if i0 <= r < i0 + plan.tile_h and j0 <= c < j0 + plan.tile_w)
        i0, j0, w2c = plan.tiles[k]
        if k not in cams:
            m = w2c.cpu().numpy().astype(np.float64)
            cam = tri @ m[:3, :3].T + m[:3, 3]
            with np.errstate(divide="ignore", invalid="ignore"):
                px = plan.focal * cam[..., :2] / cam[..., 2:] + np.array(
                    [plan.tile_w / 2.0, plan.tile_h / 2.0])
            cams[k] = cam, px
        cam, px = cams[k]
        hh = min(size, plan.tile_h, plan.height - i0)
        ww = min(size, plan.tile_w, plan.width - j0)
        r0 = int(np.clip(r - i0 - hh // 2, 0, min(plan.tile_h, plan.height - i0) - hh))
        c0 = int(np.clip(c - j0 - ww // 2, 0, min(plan.tile_w, plan.width - j0) - ww))
        near = np.flatnonzero(
            (px[:, :, 0].min(1) <= c0 + ww + 1) & (px[:, :, 0].max(1) >= c0 - 1)
            & (px[:, :, 1].min(1) <= r0 + hh + 1) & (px[:, :, 1].max(1) >= r0 - 1))
        sub = cam[near].copy()
        sub[..., 0] += sub[..., 2] * (plan.tile_w / 2.0 - c0 - ww / 2.0) / plan.focal
        sub[..., 1] += sub[..., 2] * (plan.tile_h / 2.0 - r0 - hh / 2.0) / plan.focal
        local = brute_force_pix2face(sub, plan.focal, ww, hh)
        oracle = np.where(local >= 0, near[np.clip(local, 0, None)], -1)
        got = p2f[i0 + r0:i0 + r0 + hh, j0 + c0:j0 + c0 + ww]
        equal = got == oracle
        same, total = same + int(equal.sum()), total + equal.size
        worst = min(worst, float(equal.mean()))
        for y, x in zip(*np.nonzero(~equal & ((got < 0) | (oracle < 0)))):
            background.append((i0 + r0 + int(y), j0 + c0 + int(x), int(got[y, x]),
                               int(oracle[y, x])))
    return same / total, worst, sorted(set(background))


def _oracle_check(name, plan, p2f, centres):
    """:func:`_ortho_oracle` on ``centres`` and the map's holes: the
    knife-edge contract (``ORACLE_MIN_AGREE``, face-vs-background only at
    a hole, which the caller has shown in the plain version's map too);
    at most ``HOLE_MAX_SHARE`` of the pixels are holes.  Returns the
    fields of the phase's line."""
    holes = [tuple(int(v) for v in rc) for rc in torch.nonzero(_hole_mask(p2f)).tolist()]
    agree, worst, background = _ortho_oracle(plan, p2f, list(centres) + holes)
    stray = [b for b in background if b[:2] not in holes]
    if agree < ORACLE_MIN_AGREE or stray or len(holes) > HOLE_MAX_SHARE * p2f.size:
        raise RuntimeError(f"{name} ortho vs the float64 oracle: agree {agree}, face vs "
                           f"background off the holes {stray}, holes {holes}")
    return dict(windows=len(centres) + len(holes), window_px=ORTHO_ORACLE_PX,
                agree=agree, worst_window=worst, holes=holes,
                oracle_at_holes=[b[3] for b in background if b[:2] in holes])


def _ortho_phase(mesh, dev, card=None):
    """Phase 9b: ``ortho_pix2face`` at ``ORTHO_RES_M`` on census-sized
    caps (the kernel against its plain version, bit for bit), the same
    footprint in 3 x 3 tiles (every pasted tile bit-equal to its plain
    version), both held against the float64 oracle in windows and at
    every hole, and a ~10000 px ortho in 2 x 2 tiles (one tile against the
    plain version).  Returns (the untiled configuration, the kernel rows
    at ~2500 px and on a ~5000 px tile, the launches, and the ~10000 px
    map with its bounds and EPSG)."""
    _reset_launches()
    plan = mesh.ortho_plan(resolution_m=ORTHO_RES_M)
    census, caps = _ortho_caps(mesh, plan)
    cfg = mesh.raster_config = RasterConfig(caps=caps)
    stats = {}
    _sync(dev)
    t0 = time.perf_counter()
    p2f, bounds, epsg = mesh.ortho_pix2face(resolution_m=ORTHO_RES_M, stats=stats)
    ortho_s = time.perf_counter() - t0
    launches = _launches()
    tile, row = _ortho_kernel_vs_plain(plan, cfg)
    if not np.array_equal(tile.cpu().numpy(), p2f):
        raise RuntimeError("ortho_pix2face differs from its tile's kernel run")
    coverage = float((p2f >= 0).mean())
    faces_seen = int(np.unique(p2f[p2f >= 0]).size)
    h, w = p2f.shape
    oracle = _oracle_check("untiled", plan, p2f, [
        (int(h * fy), int(w * fx)) for fy, fx in
        ((0.5, 0.5), (0.25, 0.25), (0.25, 0.75), (0.75, 0.25), (0.75, 0.75))])
    # the same footprint in tiles of at most ORTHO_TILED_MAX_PIXELS
    plan_t = mesh.ortho_plan(resolution_m=ORTHO_RES_M, max_pixels=ORTHO_TILED_MAX_PIXELS)
    _, caps_t = _ortho_caps(mesh, plan_t)
    cfg_t = mesh.raster_config = RasterConfig(caps=caps_t)
    _reset_launches()
    p2f_t, bounds_t, _ = mesh.ortho_pix2face(resolution_m=ORTHO_RES_M,
                                             max_pixels=ORTHO_TILED_MAX_PIXELS)
    for key, n in _launches().items():
        launches[key] += n
    if bounds_t != bounds or p2f_t.shape != p2f.shape:
        raise RuntimeError(f"tiled ortho: bounds {bounds_t}, shape {p2f_t.shape} against "
                           f"{bounds}, {p2f.shape}")
    for k, (i0, j0, _) in enumerate(plan_t.tiles):
        own, _ = _ortho_kernel_vs_plain(plan_t, cfg_t, k, timed=False)
        hk, wk = min(plan_t.tile_h, h - i0), min(plan_t.tile_w, w - j0)
        if not np.array_equal(own.cpu().numpy()[:hk, :wk], p2f_t[i0:i0 + hk, j0:j0 + wk]):
            raise RuntimeError(f"tiled ortho: tile {k} at ({i0}, {j0}) is not its own "
                               "kernel run")
    oracle_t = _oracle_check("tiled", plan_t, p2f_t, [
        (i0 + min(plan_t.tile_h, h - i0) // 2, j0 + min(plan_t.tile_w, w - j0) // 2)
        for i0, j0, _ in plan_t.tiles])
    # every tile's camera stands at its own distance above its own centre
    # (as the JAX package's), so the two maps part by the perspective
    # (ROADMAP C4): the share of equal pixels is a reading, not a check
    agree_t, bg_t = _knife_edge(torch.as_tensor(p2f_t), torch.as_tensor(p2f))
    # ~10000 px: 2 x 2 tiles of ~5000 px at the default max_pixels
    plan_b = mesh.ortho_plan(resolution_m=ORTHO_BIG_RES_M)
    census_b, caps_b = _ortho_caps(mesh, plan_b)
    cfg_b = mesh.raster_config = RasterConfig(caps=caps_b)
    stats_b = {}
    _reset_launches()
    _sync(dev)
    t0 = time.perf_counter()
    p2f_b, bounds_b, _ = mesh.ortho_pix2face(resolution_m=ORTHO_BIG_RES_M, stats=stats_b)
    big_s = time.perf_counter() - t0
    for key, n in _launches().items():
        launches[key] += n
    tile_b, row_b = _ortho_kernel_vs_plain(plan_b, cfg_b)
    h0, w0 = min(plan_b.tile_h, plan_b.height), min(plan_b.tile_w, plan_b.width)
    if not np.array_equal(tile_b.cpu().numpy()[:h0, :w0], p2f_b[:h0, :w0]):
        raise RuntimeError("the 10000 px ortho differs from its first tile's kernel run")
    del tile_b
    big_shape = list(p2f_b.shape)
    big_coverage = float((p2f_b >= 0).mean())
    _line("9b", shape=list(p2f.shape), res_m=ORTHO_RES_M, census=census, caps=list(caps),
          overflow=0, ortho_s=round(ortho_s, 4),
          raster_s=round(stats["raster_s"], 4), download_s=round(stats["download_s"], 4),
          coverage=coverage, faces_seen=faces_seen, px_per_face=round(
              float((p2f >= 0).sum()) / max(faces_seen, 1), 3),
          kernel=row, oracle=oracle,
          tiled=dict(tiles=len(plan_t.tiles), tile=[plan_t.tile_h, plan_t.tile_w],
                     caps=list(caps_t), tiles_equal_plain=len(plan_t.tiles),
                     oracle=oracle_t, agree_untiled=agree_t,
                     face_vs_background_untiled=bg_t),
          big=dict(shape=big_shape, tiles=len(plan_b.tiles),
                   tile=[plan_b.tile_h, plan_b.tile_w], census=census_b, caps=list(caps_b),
                   overflow=0, seconds=round(big_s, 4),
                   raster_s=round(stats_b["raster_s"], 4),
                   download_s=round(stats_b["download_s"], 4), coverage=big_coverage,
                   kernel=row_b),
          launches=launches, card=card)
    return cfg, row, row_b, launches, dict(p2f=p2f_b, bounds=bounds_b, epsg=epsg)


def _polygon_phase(folder, survey, mesh, dtm, cfg, dev, card=None):
    """Phase 9c: phase 8's six star polygons painted onto the mesh, the
    raster vector export at ``ORTHO_RES_M``, and the ``label_polygons``
    entry point without and with the DTM and in the exact mode: every
    polygon that no other overlaps gets its own species back.  Returns the
    launches."""
    folder = Path(folder)
    on = {} if dev.type == "cuda" else {"device": dev}  # the card: the default
    ids, names = mesh.get_values_for_verts_from_vector(survey["labels_file"], "species")
    mesh.set_texture(ids, is_vertex=True, IDs_to_labels=names)
    face_labels = mesh.vert_to_face_texture()[:, 0]
    mesh.raster_config = cfg
    _reset_launches()
    st = {}
    _sync(dev)
    t0 = time.perf_counter()
    vd = mesh.export_face_labels_vector(face_labels, export_file=folder / "classes.geojson",
                                        resolution_m=ORTHO_RES_M, mode="raster", stats=st)
    export_s = time.perf_counter() - t0
    launches = _launches()
    painted = sorted(int(c) for c in np.unique(face_labels[np.isfinite(face_labels)]))
    if sorted(set(vd.attributes["class_ID"])) != painted:
        raise RuntimeError(f"raster export classes {sorted(set(vd.attributes['class_ID']))}"
                           f", painted {painted}")
    np.save(folder / "face_labels.npy", face_labels)
    polys = VectorData.read_file(survey["labels_file"])
    species = polys.attributes["species"]
    alone = [i for i, a in enumerate(polys.geometries)
             if all(polygon_intersection_area(a, b) == 0
                    for j, b in enumerate(polys.geometries) if j != i)]
    if not alone:
        raise RuntimeError("every label polygon overlaps another: nothing to check")
    runs = {}
    for run, kw in (("raster", {}),
                    ("raster_dtm", dict(DTM_file=dtm, height_above_ground_threshold=
                                        HEIGHT_THRESHOLDS[0],
                                        ground_voting_weight=GROUND_VOTING_WEIGHT)),
                    ("exact", dict(mode="exact"))):
        stats = {}
        _reset_launches()
        _sync(dev)
        t0 = time.perf_counter()
        labels = label_polygons(
            survey["mesh_file"], None, folder / "face_labels.npy", survey["labels_file"],
            folder / f"labelled_{run}.geojson", transform_filename=survey["cameras_file"],
            IDs_to_labels=names, raster_config=cfg, resolution_m=ORTHO_RES_M,
            stats=stats, **on, **kw)
        _sync(dev)
        for key, n in _launches().items():
            launches[key] += n
        wrong = [i for i in alone if labels[i] != species[i]]
        if wrong:
            raise RuntimeError(f"label_polygons ({run}): polygons {wrong} that no other "
                               f"overlaps labelled {[labels[i] for i in wrong]}, not "
                               f"{[species[i] for i in wrong]}")
        written = VectorData.read_file(folder / f"labelled_{run}.geojson")
        if written.attributes["predicted_labels"] != labels:
            raise RuntimeError(f"label_polygons ({run}) wrote other labels")
        runs[run] = dict(seconds=round(time.perf_counter() - t0, 4), labels=labels,
                         **{k: round(v, 4) for k, v in stats.items()
                            if isinstance(v, float)})
    _line("9c", polygons=len(polys), species=species, alone=alone,
          painted_classes=painted, export_polygons=len(vd), export_s=round(export_s, 4),
          export_stages_s={k: round(v, 4) for k, v in st.items() if isinstance(v, float)},
          label_polygons=runs, launches=launches, card=card)
    return launches


def _phase9(folder, survey, verts, cfg, dev, card=None):
    """Phase 9 on phase 8's survey on disk: 9a (DTM), 9b (ortho), 9c
    (polygons).  Returns (the kernels' launches, the ortho kernel rows at
    ~2500 px and on a ~5000 px tile, the ~10000 px ortho map with its
    bounds and EPSG)."""
    t0 = time.perf_counter()
    mesh, dtm, launches = _dtm_phase(folder, survey, verts, cfg, dev, card)
    cfg_o, row, row_b, launches_b, big = _ortho_phase(mesh, dev, card)
    launches_c = _polygon_phase(folder, survey, mesh, dtm, cfg_o, dev, card)
    for more in (launches_b, launches_c):
        for k, n in more.items():
            launches[k] += n
    _line("9", seconds=round(time.perf_counter() - t0, 3), launches=launches)
    return launches, row, row_b, big


# -- phase 10: image selection; ortho chips, assembled predictions, metrics ------------

# a survey of hundreds of 4K images to select from; at 400 views the
# check's plain dense greedy alone took 41 s on an H100 machine's host
# (every view is chosen at scale 0.05, and each pick copies the uncovered
# rows of the dense matrix)
SELECTION_VIEWS = 200
SELECTION_SCALE = 0.05  # determine_minimum_overlapping_images' default
# views of 10a held against the plain raster and counts: at 0.05 a tile's
# list holds tens of thousands of faces, and the plain raster takes ~0.2 s a
# view on the card (it evaluates every listed face at every pixel of a tile)
SELECTION_PLAIN_EVERY = 10
CHIP_SIZE, CHIP_STRIDE = 2048, 1024  # up to 4 chips over a pixel
CHIP_MAX_OVERLAP = 4
CHIP_TILE = (512, 512)  # the ortho GeoTIFF's deflate tiles
# the ortho's colours: a species' colour, shaded by its face, or the ground's
SPECIES_RGB = np.array([[34, 139, 34], [0, 100, 0], [154, 205, 50], [85, 107, 47]],
                       np.int32)
GROUND_RGB = (139, 115, 85)


def encode_png_filtered(image, filters) -> bytes:
    """The bytes of a PNG file of a uint8 / uint16 (H, W) or (H, W, C)
    image (C of 2-4) whose row ``y`` carries filter type ``filters[y]``
    (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth).  An encoder's predictors
    read the original bytes, so every row is one vectorised pass."""
    img = np.asarray(image)
    h, w = img.shape[:2]
    channels = 1 if img.ndim == 2 else img.shape[2]
    bpp = channels * img.dtype.itemsize
    rows = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">")))
    x = rows.view(np.uint8).reshape(h, w * bpp).astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    kinds = np.asarray(filters, np.uint8)
    pred = np.choose(kinds[:, None].astype(np.intp),
                     (np.zeros_like(x), a, b, (a + b) >> 1, paeth))
    raw = np.concatenate([kinds[:, None], ((x - pred) & 0xFF).astype(np.uint8)], axis=1)
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[channels]
    header = struct.pack(">IIBBBBB", w, h, 8 * img.dtype.itemsize, color_type, 0, 0, 0)
    chunk = png_io._chunk
    return (png_io.PNG_SIGNATURE + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), PNG_ZLIB_LEVEL))
            + chunk(b"IEND", b""))


def _selection_run(mesh_file, cameras_file, scale, dev, card=None, phase="10a",
                   plain_every=1, picks=None):
    """``determine_minimum_overlapping_images`` with ``device`` at its
    default (or ``dev`` off the card) on census-sized caps: one raster and
    one counts launch a view (an overflow raises), the visibility of every
    ``plain_every``-th view equal to a run of those views through the
    plain raster and counts, the picks equal to the plain greedy over the
    dense matrix (built on the host for this check only) and every seen
    face covered.  Returns the launches; ``picks``, when given, gets the
    picks and the caps under the phase's name."""
    on = {} if torch.device(dev).type == "cuda" else {"device": dev}
    cams = MetashapeCameraSet(cameras_file, Path(cameras_file).parent / "images")
    mesh = TexturedMesh(mesh_file, transform_filename=cameras_file, device=dev)
    census = mesh.view_raster_census(cams, scale)
    cfg = mesh.raster_config = census_caps(census, mesh.raster_config)
    caps = cfg.caps
    on_card = torch.device(dev).type == "cuda"
    if on_card and phase == "10a":
        # the front end's kernels against their plain versions at this scale
        for i in (0, 1):
            b = cams.get_camera_batch([i], image_scale=scale, device=dev)
            _front_vs_plain(f"10a_view{i}", mesh._tri_soa_device(cams, cfg.bin_block),
                            b.world_to_cam[0], b.f[0], cfg, h=b.image_height,
                            w=b.image_width)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    stats = {}
    _reset_launches()
    _sync(dev)
    t0 = time.perf_counter()
    chosen = determine_minimum_overlapping_images(
        mesh_file, cameras_file, Path(cameras_file).parent / "images",
        aggregate_image_scale=scale, min_observations=1, raster_config=cfg,
        stats=stats, **on)
    _sync(dev)
    wall = time.perf_counter() - t0
    peak = round(torch.cuda.max_memory_allocated() / 1e9, 3) if on_card else None
    launches = _launches()
    n = len(cams)
    want = {"raster_tiles": n * on_card, "face_class_counts": n * on_card,
            "s_raster": 0, "onehot_class": 0, "face_sums": 0}
    if _back(launches) != want:
        raise RuntimeError(f"{phase}: launches {launches}, expected {want}")
    _demand_front(phase, launches, n * on_card)
    vis = stats["visibility"]
    sensor = cams.sensors[cams.sensor_IDs[0]]
    held = list(range(0, n, plain_every))
    seg = SegmentorCameraSet(cams.get_subset_cameras(held), ImageIDSegmentor(
        (sensor["image_height"], sensor["image_width"]), len(held)))
    t0 = time.perf_counter()
    plain, _ = _plain_index_run(mesh, seg, len(held), {}, aggregate_img_scale=scale,
                                check_null_image=False)
    plain_run_s = time.perf_counter() - t0
    if not _csr_equal(visibility_matrix(plain, 1), vis[:, held]):
        raise RuntimeError(f"{phase}: the visibility of views {held} differs from "
                           "the plain run's")
    dense = vis.toarray()
    t0 = time.perf_counter()
    chosen_plain = greedy_set_cover(dense)
    plain_s = time.perf_counter() - t0
    del dense
    if chosen != chosen_plain:
        raise RuntimeError(f"{phase}: picks {chosen} differ from the plain greedy's "
                           f"{chosen_plain}")
    if picks is not None:
        picks[phase] = (chosen, tuple(caps))
    seen = np.diff(vis.indptr) > 0
    covered = np.asarray(vis[:, chosen].sum(axis=1)).ravel() > 0
    if (seen & ~covered).any():
        raise RuntimeError(f"{phase}: {int((seen & ~covered).sum())} seen faces are "
                           "not covered by the chosen views")

    def view_ms(key):
        vals = [v[key] for v in stats["views"]]
        return dict(median=round(statistics.median(vals) * 1e3, 4),
                    max=round(max(vals) * 1e3, 4))

    _line(phase, views=n, scale=scale, image=[int(round(sensor["image_height"] * scale)),
                                             int(round(sensor["image_width"] * scale))],
          census=census, caps=list(caps), launches=launches, overflow=0,
          wall_s=round(wall, 4), views_per_s=round(n / wall, 3),
          stages_s={k: round(stats[k], 4) for k in ("load_s", "aggregate_s", "greedy_s")},
          view_ms={k: view_ms(k) for k in (
              "segment_s", "upload_s", "remap_s", "pix2face_s", "counts_s",
              "nonzero_s", "download_s", "host_s")},
          greedy_plain_s=round(plain_s, 4), n_chosen=len(chosen),
          seen_faces=stats["seen_faces"], nnz=int(vis.nnz),
          plain_run_views=len(held), plain_run_s=round(plain_run_s, 4),
          plain_run_equal=True,
          picks_equal_plain=True, peak_mem_gb=peak, card=card)
    return launches


def _selection_phase(folder, survey, sensors, dev, card=None, n_views=SELECTION_VIEWS,
                     scale=SELECTION_SCALE, width=W, height=H, picks=None):
    """Phase 10a: ``n_views`` cameras of the bench suite's pattern as a
    Metashape XML beside phase 5's mesh, selected at ``scale``; then phase
    8's 20 views at scale 1.0.  Returns the launches of both runs
    (``picks``: see :func:`_selection_run`)."""
    cameras_file = Path(folder) / "selection_cameras.xml"
    _write_cameras(cameras_file, _suite_cameras(n_views=n_views), sensors,
                   _suite_sensor_ids(n_views), width, height)
    launches = _selection_run(survey["mesh_file"], cameras_file, scale, dev, card,
                              plain_every=SELECTION_PLAIN_EVERY, picks=picks)
    more = _selection_run(survey["mesh_file"], survey["cameras_file"], 1.0, dev, card,
                          phase="10a_full", picks=picks)
    return {k: n + more[k] for k, n in launches.items()}


def _ortho_image(big, face_labels, dev):
    """(H, W, 4) uint8 RGBA of the ~10000 px ortho map: a labelled face in
    its species' colour, the others in the ground's, each shaded by its
    face id; alpha 0 where no face was hit."""
    p2f = torch.as_tensor(big["p2f"], device=dev).long()
    hit = p2f >= 0
    labels = torch.as_tensor(face_labels, device=dev)[p2f.clamp(min=0)]
    species = torch.where(hit & torch.isfinite(labels), labels, -1).long()
    rgb = torch.where((species >= 0).unsqueeze(-1),
                      torch.as_tensor(SPECIES_RGB, device=dev)[species.clamp(min=0)],
                      torch.tensor(GROUND_RGB, device=dev))
    shade = ((p2f * 2654435761) >> 13) & 15
    rgba = torch.zeros(p2f.shape + (4,), dtype=torch.uint8, device=dev)
    rgba[..., :3] = torch.where(hit.unsqueeze(-1), rgb - shade.unsqueeze(-1), 0).to(
        torch.uint8)
    rgba[..., 3] = hit.to(torch.uint8) * 255
    return rgba.cpu().numpy()


def _ortho_predict_phase(folder, survey, big, dev, card=None):
    """Phase 10b on phase 9's ~10000 px ortho map: the map coloured by the
    painted species as an RGBA GeoTIFF (deflate tiles); ``write_chips``
    (``chip_ortho``) with phase 5's six star polygons as labels; the label
    chips as the predictions ("a perfect segmentor"), a third of them
    re-encoded with PNG filter types 3 and 4; ``assemble_ortho_predictions``
    with ``device`` at its default, bit-equal to the plain numpy assembly
    and equal to the burned labels on every observed pixel; the raster
    confusion matrix of the two diagonal; and the vector confusion matrix
    of phase 9c's labelled polygons against the stars, raster and exact.
    Returns the launches (none: the phase runs no kernel)."""
    root = Path(folder)
    out = root / "ortho_predict"
    out.mkdir()
    on = {} if torch.device(dev).type == "cuda" else {"device": dev}
    _reset_launches()
    t0 = time.perf_counter()
    p2f = big["p2f"]
    h, w = p2f.shape
    x0, y0, x1, y1 = big["bounds"]
    grid = Raster(np.broadcast_to(np.uint8(0), (h, w)),
                  ((x1 - x0) / w, 0.0, x0, 0.0, -(y1 - y0) / h, y1), big["epsg"])
    rgba = _ortho_image(big, np.load(root / "face_labels.npy"), dev)
    ortho_file = out / "ortho.tif"
    write_geotiff(ortho_file, Raster(rgba, grid.transform, grid.epsg),
                  compression="deflate", tile=CHIP_TILE)
    ortho_s = time.perf_counter() - t0
    del rgba

    def burned_labels(h, w):
        """The labels write_chips burns into the ortho's grid."""
        labels = VectorData.read_file(survey["labels_file"]).to_crs(big["epsg"])
        return rasterize_polygons(
            labels.geometries, [mapping[v] for v in labels.attributes["species"]],
            grid.bounds, (h, w), background=255).astype(np.uint8)

    chips = out / "chips"
    t0 = time.perf_counter()
    mapping = chip_ortho(ortho_file, chips, CHIP_SIZE, CHIP_STRIDE,
                         label_vector_file=survey["labels_file"], label_column="species")
    write_chips_s = time.perf_counter() - t0
    imgs = sorted((chips / "imgs").glob("*.png"))
    anns = sorted((chips / "anns").glob("*.png"))
    if [f.name for f in imgs] != [f.name for f in anns] or not anns:
        raise RuntimeError(f"write_chips: {len(imgs)} image and {len(anns)} label chips")
    windows = list(create_windows((h, w), CHIP_SIZE, CHIP_STRIDE))
    chip = read_image_or_numpy(imgs[0])
    encode_ms = _host_ms(lambda: png_io.encode_png(chip))
    decode_ms = _decode_times(chip, burned_labels(h, w))

    # predictions: the label chips, every third re-encoded with rows of
    # filter types 3 and 4 in turn
    preds = out / "preds"
    preds.mkdir()
    chip_decode_ms = {"filters_0_2": [], "filters_3_4": []}
    for k, f in enumerate(anns):
        data = f.read_bytes()
        if k % 3 == 0:
            label = png_io.decode_png(data)
            data = encode_png_filtered(label, 3 + np.arange(label.shape[0]) % 2)
            if not np.array_equal(png_io.decode_png(data), label):
                raise RuntimeError(f"{f.name}: filter types 3-4 decode to other pixels")
        (preds / f.name).write_bytes(data)
        if k < 12:
            key = "filters_3_4" if k % 3 == 0 else "filters_0_2"
            chip_decode_ms[key].append(_host_ms(lambda: png_io.decode_png(data), runs=1))
    decode_ms["label_chip"] = {k: statistics.median(v) for k, v in chip_decode_ms.items()}
    pred_files = sorted(preds.glob("*"))

    n_classes = len(mapping)
    st = {}
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _sync(dev)
    t0 = time.perf_counter()
    assemble_ortho_predictions(
        preds, raster_file=ortho_file, num_classes=n_classes,
        class_savefile=out / "classes.tif", counts_savefile=out / "counts.tif",
        max_overlapping_tiles=CHIP_MAX_OVERLAP, stats=st, **on)
    _sync(dev)
    assemble_s = time.perf_counter() - t0
    peak = (round(torch.cuda.max_memory_allocated() / 1e9, 3)
            if torch.device(dev).type == "cuda" else None)
    launches = _launches()
    t0 = time.perf_counter()
    assemble_tiled_predictions_plain(
        ortho_file, pred_files, n_classes, out / "classes_plain.tif",
        counts_savefile=out / "counts_plain.tif", max_overlapping_tiles=CHIP_MAX_OVERLAP)
    plain_s = time.perf_counter() - t0
    classes, counts = (read_geotiff(out / n) for n in ("classes.tif", "counts.tif"))
    for name, got in (("classes", classes), ("counts", counts)):
        want = read_geotiff(out / f"{name}_plain.tif")
        if not (np.array_equal(got.data, want.data) and got.data.dtype == want.data.dtype
                and got.transform == want.transform and got.nodata == want.nodata):
            raise RuntimeError(f"assembled {name} differ from the plain assembly")

    # the assembly against the labels write_chips burned
    burned = burned_labels(h, w)
    observed = counts.data > 0
    wrong = int((classes.data[observed] != burned[observed]).sum())
    not_nodata = int((classes.data[~observed] != 255).sum())
    if wrong or not_nodata:
        raise RuntimeError(f"assembled classes: {wrong} observed pixels off the burned "
                           f"labels, {not_nodata} unobserved pixels not nodata")
    write_geotiff(out / "burned.tif", Raster(burned, grid.transform, grid.epsg, 255))
    t0 = time.perf_counter()
    cf, names = compute_confusion_matrix_from_geospatial(
        out / "classes.tif", out / "burned.tif", "species",
        class_names=list(range(n_classes)), **on)
    cf_s = time.perf_counter() - t0
    if (cf - np.diag(np.diag(cf))).any() or not np.trace(cf):
        raise RuntimeError(f"raster confusion matrix not diagonal: {cf.tolist()}")
    # phase 9c's labelled stars against the stars
    labelled = VectorData.read_file(root / "labelled_raster.geojson")
    predicted = VectorData(labelled.geometries,
                           {"species": labelled.attributes["predicted_labels"]},
                           epsg=labelled.epsg)
    vector = {}
    for mode in ("raster", "exact"):
        t0 = time.perf_counter()
        cf_v, classes_v = cf_from_vector_vector(predicted, survey["labels_file"],
                                                "species", mode=mode)
        metrics = compute_comprehensive_metrics(cf_v)
        vector[mode] = dict(seconds=round(time.perf_counter() - t0, 4), classes=classes_v,
                            accuracy=metrics["accuracy"],
                            recall=metrics["class_averaged_recall"],
                            precision=metrics["class_averaged_precision"])
    if not all(np.isfinite(v["accuracy"]) and v["accuracy"] > 0 for v in vector.values()):
        raise RuntimeError(f"vector confusion matrices: {vector}")
    if any(launches.values()):
        raise RuntimeError(f"10b launched kernels: {launches}")
    metrics = compute_comprehensive_metrics(cf)
    _line("10b", shape=[h, w], ortho_s=round(ortho_s, 4),
          ortho_bytes=ortho_file.stat().st_size, windows=len(windows), chips=len(anns),
          mapping=mapping, write_chips_s=round(write_chips_s, 4),
          encode_ms_per_chip=encode_ms, decode_ms=decode_ms,
          assemble_s=round(assemble_s, 4),
          assemble_stages_s={k: round(v, 4) for k, v in st.items() if k.endswith("_s")},
          counts_bytes=st["counts_bytes"], peak_mem_gb=peak,
          assemble_plain_s=round(plain_s, 4), bit_equal_plain=True,
          observed_share=round(float(observed.mean()), 6),
          labelled_observed=int((observed & (burned != 255)).sum()),
          raster_cf_s=round(cf_s, 4), raster_cf_diagonal=np.diag(cf).tolist(),
          raster_accuracy=metrics["accuracy"], vector=vector, launches=launches,
          card=card)
    return launches


def _decode_times(rgb_chip, labels):
    """``decode_png`` milliseconds of an RGB chip and of a 2160 x 3840 crop
    of a label raster (a 4K label image), each as the port writes it (filter
    type 0) and with rows of filter types 3 and 4 in turn."""
    out = {}
    for name, image in (("rgb_chip", rgb_chip), ("label_4k", labels[:2160, :3840])):
        plain = png_io.encode_png(image)
        late = encode_png_filtered(image, 3 + np.arange(image.shape[0]) % 2)
        if not np.array_equal(png_io.decode_png(late), image):
            raise RuntimeError(f"{name}: filter types 3-4 decode to other pixels")
        out[name] = dict(shape=list(image.shape),
                         filters_0=_host_ms(lambda: png_io.decode_png(plain)),
                         filters_3_4=_host_ms(lambda: png_io.decode_png(late)))
    return out


def _host_ms(fn, runs=3):
    """Median milliseconds of ``fn()`` on the host's clock."""
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return round(statistics.median(times), 3)


# -- phase 11: COLMAP and the 360 rig, composites and viewers, rasterize_batch,
# selection at its default caps ------------------------------------------------

COLMAP_BIG_IMAGES = 1000  # a real export's images.txt: 1,000 images ...
COLMAP_BIG_POINTS = 2000  # ... of 2,000 keypoints each
COLMAP_POSE_ATOL = 1e-12
RIG_STATIONS = 10  # cut from a walk's dozens of stations
RIG_SENSOR = 1344  # a 90 deg member keeps the 5.6K panorama's angular resolution
RIG_PANO = (2688, 5376)  # a GoPro MAX 5.6K equirectangular capture
COMPOSITE_VIEWS = 4


def _quaternion_wxyz(rot):
    """A rotation matrix's unit quaternion (w, x, y, z), w >= 0."""
    m = np.asarray(rot, np.float64)
    # Shepperd's method: divide by the largest component, so none is the
    # square root of a cancellation (~1e-8 where it should be 0)
    t = np.trace(m)
    k = int(np.argmax([t, m[0, 0], m[1, 1], m[2, 2]]))
    if k == 0:
        s = 2 * np.sqrt(1 + t)
        q = [s / 4, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s]
    elif k == 1:
        s = 2 * np.sqrt(1 + m[0, 0] - m[1, 1] - m[2, 2])
        q = [(m[2, 1] - m[1, 2]) / s, s / 4, (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s]
    elif k == 2:
        s = 2 * np.sqrt(1 - m[0, 0] + m[1, 1] - m[2, 2])
        q = [(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, s / 4, (m[1, 2] + m[2, 1]) / s]
    else:
        s = 2 * np.sqrt(1 - m[0, 0] - m[1, 1] + m[2, 2])
        q = [(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s, (m[1, 2] + m[2, 1]) / s, s / 4]
    q = np.array(q) * (1.0 if q[0] >= 0 else -1.0)
    return q / np.linalg.norm(q)


def _write_colmap(folder, c2ws, sensors, sensor_ids, width, height, points_rows,
                  images_name="images.txt"):
    """A COLMAP text export as COLMAP writes it (17 significant digits):
    ``cameras.txt`` with one SIMPLE_RADIAL sensor per sensor of ``sensors``
    (id + 1; its ``k1``, 0 without distortion) and ``images_name`` with the
    world -> camera poses of ``c2ws``, image ``k``'s POINTS2D row
    ``points_rows[k % len(points_rows)]`` ("" for no points)."""
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    cams = ["# Camera list with one line of data per camera:",
            "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]",
            f"# Number of cameras: {len(sensors)}"]
    for sid in sorted(sensors):
        s = sensors[sid]
        k1 = (s.get("distortion_params") or {}).get("k1", 0.0)
        cams.append(f"{sid + 1} SIMPLE_RADIAL {width} {height} {s['f']!r} "
                    f"{width / 2 + s.get('cx', 0.0)!r} {height / 2 + s.get('cy', 0.0)!r} "
                    f"{k1!r}")
    (folder / "cameras.txt").write_text("\n".join(cams) + "\n")
    lines = ["# Image list with two lines of data per image:",
             "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME",
             "#   POINTS2D[] as (X, Y, POINT3D_ID)",
             f"# Number of images: {len(c2ws)}, mean observations per image: 1"]
    for k, c2w in enumerate(c2ws):
        w2c = np.linalg.inv(c2w)
        values = " ".join(f"{v:.17g}" for v in (*_quaternion_wxyz(w2c[:3, :3]),
                                                 *w2c[:3, 3]))
        lines.append(f"{k + 1} {values} {sensor_ids[k] + 1} view_{k:04d}.png")
        lines.append(points_rows[k % len(points_rows)])
    (folder / images_name).write_text("\n".join(lines) + "\n")
    return folder / "cameras.txt", folder / images_name


def _points_row(rng, n, width, height):
    """A POINTS2D row of ``n`` seeded keypoints (X Y POINT3D_ID)."""
    xy = rng.random((n, 2)) * (width, height)
    ids = rng.integers(-1, 10 ** 6, n)
    return " ".join(f"{x:.6f} {y:.6f} {i}" for (x, y), i in zip(xy, ids))


def _lens_setup(mesh, cams, i, cfg, h, w):
    """View ``i``'s triangle setup in the lens model the aggregation
    rasterizes it in (distorted space for a sensor with distortion)."""
    b = cams.get_camera_batch([i], device=mesh.device)
    use_dist = mesh._resolve_distortion(cams, i, None)
    return setup_from_soa(
        mesh._tri_soa_device(cams, cfg.bin_block), b.world_to_cam[0], b.f[0], w, h,
        cfg.znear, distortion=(b.distortion[0], b.cx[0], b.cy[0]) if use_dist else None)


def _held_vs_plain(name, mesh, cams, i, cfg, scale=1.0, use_dist=False, cls=None,
                   n_classes=None):
    """View ``i``'s raster kernel (and with ``cls`` the counts kernel)
    against the plain versions, bit for bit, at zero overflow.  Returns
    the kernel's pix2face."""
    batch = cams.get_camera_batch([i], image_scale=scale, device=mesh.device)
    h, w = batch.image_height, batch.image_width
    setup = setup_from_soa(
        mesh._tri_soa_device(cams, cfg.bin_block), batch.world_to_cam[0], batch.f[0],
        w, h, cfg.znear,
        distortion=(batch.distortion[0], batch.cx[0], batch.cy[0]) if use_dist else None)
    binned = bin_triangles(setup, cfg, h, w)
    cand, counts = binned_face_lists(binned, cfg)
    planes = setup.planes.contiguous()
    p2f = raster_tiles.raster_tiles(planes, setup.bbox, cand, counts, cfg, h, w)
    plain = raster_tiles.raster_tiles_plain(planes, cand, counts, cfg, h, w)
    if int(binned.overflow) or not torch.equal(p2f, plain):
        raise RuntimeError(f"{name} view {i}: overflow {int(binned.overflow)}, "
                           f"{int((p2f != plain).sum())} pixels off the plain raster")
    if cls is not None:
        n_faces = planes.shape[0]
        got = face_counts.face_class_counts(p2f, cls, n_faces, n_classes)
        want = face_counts.face_class_counts_plain(p2f, cls, n_faces, n_classes)
        if not torch.equal(got, want):
            raise RuntimeError(f"{name} view {i}: counts kernel vs plain differ by "
                               f"{int((got - want).abs().sum())}")
    return p2f


def _colmap_phase(folder, mesh, sensors, dev, card=None, n_views=PIPELINE_VIEWS,
                  width=W, height=H, n_big=COLMAP_BIG_IMAGES, n_points=COLMAP_BIG_POINTS):
    """Phase 11a: the bench suite's ``n_views`` views as a COLMAP text export
    (a SIMPLE_RADIAL sensor per suite sensor, k the suite's k1), parsed by
    ``COLMAPCameraSet`` (poses within ``COLMAP_POSE_ATOL``), a real export's
    ``images.txt`` of ``n_big`` images with ``n_points``-point rows parsed
    and timed, and the views' seeded labels aggregated through the COLMAP
    set and through a ``CameraSet`` of the matrices and k1-only sensors the
    export was written from: view 0's pix2face by the knife-edge contract
    between the two, view counts and summed fractions equal off the faces
    the two sets' rasters swap.  Returns the launches of both runs."""
    folder = Path(folder) / "colmap"
    rng = np.random.default_rng(11)
    c2ws = _suite_cameras(n_views=n_views)
    ids = _suite_sensor_ids(n_views)
    k1_sensors = {sid: {**{k: v for k, v in s.items() if k != "distortion_params"},
                        "distortion_params": {"k1": float(
                            (s.get("distortion_params") or {}).get("k1", 0.0))}}
                  for sid, s in sensors.items()}
    rows = ["", _points_row(rng, 40, width, height)]
    t0 = time.perf_counter()
    cameras_txt, images_txt = _write_colmap(folder, c2ws, sensors, ids, width, height,
                                            rows)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    colmap = COLMAPCameraSet(cameras_txt, images_txt, image_folder=folder / "images")
    parse_s = time.perf_counter() - t0
    pose_err = max(float(np.abs(a - b).max())
                   for a, b in zip(colmap.cam_to_world_transforms, c2ws))
    if len(colmap) != n_views or pose_err > COLMAP_POSE_ATOL:
        raise RuntimeError(f"11a: {len(colmap)} views parsed, pose error {pose_err}")
    if colmap.sensors != {sid + 1: s for sid, s in k1_sensors.items()}:
        raise RuntimeError(f"11a: sensors {colmap.sensors} against {k1_sensors}")
    # a real export's size: the POINTS2D rows are skipped unparsed
    big_c2ws = _suite_cameras(n_views=n_big)
    _, big_txt = _write_colmap(folder, big_c2ws, sensors, _suite_sensor_ids(n_big),
                               width, height, [_points_row(rng, n_points, width, height)],
                               images_name="images_big.txt")
    t0 = time.perf_counter()
    big = COLMAPCameraSet(cameras_txt, big_txt)
    big_parse_s = time.perf_counter() - t0
    big_err = max(float(np.abs(a - b).max())
                  for a, b in zip(big.cam_to_world_transforms, big_c2ws))
    if len(big) != n_big or big_err > COLMAP_POSE_ATOL:
        raise RuntimeError(f"11a: the big export parsed {len(big)} views, pose error "
                           f"{big_err}")
    # the aggregation through both sets, on the same seeded labels
    names = [f.name for f in colmap.image_filenames]
    labels = rng.integers(0, N_CLASSES, (n_views, height, width), dtype=np.int8)
    reference = CameraSet(c2ws, {sid + 1: s for sid, s in k1_sensors.items()},
                          image_filenames=colmap.image_filenames,
                          sensor_IDs=[sid + 1 for sid in ids])
    runs = {}
    launches = {}
    for key, cams in (("colmap", colmap), ("matrices", reference)):
        seg = SegmentorCameraSet(cams, LabelSegmentor(labels, N_CLASSES, names))
        _reset_launches()
        _sync(dev)
        t0 = time.perf_counter()
        avg, info = mesh.aggregate_projected_images(seg)
        _sync(dev)
        runs[key] = (avg, info, time.perf_counter() - t0)
        for name, n in _launches().items():
            launches[name] = launches.get(name, 0) + n
    on_card = torch.device(dev).type == "cuda"
    want = n_views * on_card
    if launches["raster_tiles"] < 2 * want or launches["face_class_counts"] < 2 * want:
        raise RuntimeError(f"11a: launches {launches} for 2 x {n_views} views")
    _demand_front("11a", launches, 2 * want)
    # the two sets' rasters in the aggregation's lens model, view by view, at
    # caps from their census
    sets = (colmap, reference)
    cfg = census_config_of(mesh.raster_config)
    census = torch.stack([
        bin_triangles(_lens_setup(mesh, cams, i, cfg, height, width), cfg, height, width,
                      return_census=True)
        for cams in sets for i in range(n_views)]).amax(0).tolist()
    cfg = census_caps(census, cfg)
    swapped = torch.zeros(mesh.n_faces + 1, dtype=torch.bool, device=dev)
    differ = 0
    for i in range(n_views):
        p2f = []
        for cams in sets:
            got, binned = rasterize_setup(_lens_setup(mesh, cams, i, cfg, height, width),
                                          cfg, height, width)
            if int(binned.overflow):
                raise RuntimeError(f"11a view {i}: census caps {cfg.caps} overflow")
            p2f.append(got)
        agree, bg = _knife_edge(p2f[0], p2f[1])
        if agree < ORACLE_MIN_AGREE or bg:
            raise RuntimeError(f"11a view {i}: COLMAP vs matrices agree {agree}, {bg} "
                               "face vs background")
        d = p2f[0] != p2f[1]
        differ += int(d.sum())
        swapped[p2f[0][d].long()] = True
        swapped[p2f[1][d].long()] = True
        if i == 0:
            chain0 = p2f[0]
    view0 = _held_vs_plain("11a", mesh, colmap, 0, cfg,
                           use_dist=mesh._resolve_distortion(colmap, 0, None),
                           cls=torch.as_tensor(labels[0], dtype=torch.int32, device=dev),
                           n_classes=N_CLASSES)
    if not torch.equal(view0, chain0):
        raise RuntimeError("11a: view 0's kernel raster is not the chain's")
    keep = ~swapped[: mesh.n_faces].cpu().numpy()
    (avg_c, info_c, s_c), (avg_m, info_m, s_m) = runs["colmap"], runs["matrices"]
    for key in ("projection_counts", "summed_projections"):
        if not np.array_equal(info_c[key][keep], info_m[key][keep]):
            raise RuntimeError(f"11a: {key} of the COLMAP set differ off the swapped faces")
    seen = info_c["projection_counts"] > 0
    if seen.mean() <= 0.5 or not np.isfinite(avg_c[seen]).all():
        raise RuntimeError(f"11a: {seen.mean()} of the faces seen")
    _line("11a", views=n_views, image=[height, width], sensors=len(colmap.sensors),
          pose_max_err=pose_err, write_s=round(write_s, 4), parse_s=round(parse_s, 5),
          big=dict(images=n_big, points_per_image=n_points,
                   bytes=big_txt.stat().st_size, parse_s=round(big_parse_s, 4),
                   views_per_s=round(n_big / big_parse_s, 1), pose_max_err=big_err),
          aggregate_s=dict(colmap=round(s_c, 4), matrices=round(s_m, 4)),
          views_per_s=round(n_views / s_c, 3), pixels_differ=differ,
          swapped_faces=int((~keep).sum()), seen_frac=round(float(seen.mean()), 6),
          view0_equal_plain=True, overflow=0, launches=launches, card=card)
    return launches


def _rig_phase(folder, dev, card=None, n_stations=RIG_STATIONS, sensor=RIG_SENSOR,
               pano=RIG_PANO):
    """Phase 11b: ``create_undercanopy_survey`` with ``n_stations`` 360
    stations of ``pano`` panoramas and rig members of ``sensor`` px (its
    renders at the caps of its own census), then
    ``create_rig_cameras_from_equirectangular``, ``LookUpSegmentor`` and
    aggregation at caps from the rig views' census:
    every seen face's label recovered, more than half the faces seen, two
    canopy classes or more (``tests/test_rig_e2e.py``'s checks).  Returns
    the aggregation's launches (the survey's renders are printed apart:
    they make the test data)."""
    stats = {}
    _reset_launches()
    t0 = time.perf_counter()
    survey = create_undercanopy_survey(Path(folder) / "undercanopy", n_stations=n_stations,
                                       sensor=sensor, pano_size=pano, device=dev,
                                       stats=stats)
    build_s = time.perf_counter() - t0
    survey_launches = _launches()
    rig = create_rig_cameras_from_equirectangular(
        camera_file=survey["cameras_file"], original_images=survey["equirect_folder"],
        perspective_images=survey["prediction_folder"], rig_camera=survey["rig_camera"],
        rig_orientations=survey["rig_orientations"],
        perspective_filename_format_str=survey["format_str"])
    mesh = TexturedMesh(survey["mesh_file"], transform_filename=survey["cameras_file"],
                        device=dev)
    census = mesh.view_raster_census(rig, 1.0)
    cfg = mesh.raster_config = census_caps(census, mesh.raster_config)
    caps = cfg.caps
    seg = SegmentorCameraSet(rig, LookUpSegmentor(
        survey["prediction_folder"], survey["prediction_folder"], survey["n_classes"]))
    _reset_launches()
    _sync(dev)
    t0 = time.perf_counter()
    averaged, _ = mesh.aggregate_projected_images(seg)
    _sync(dev)
    aggregate_s = time.perf_counter() - t0
    launches = _launches()
    n_views = n_stations * len(survey["rig_orientations"])
    if len(rig) != n_views:
        raise RuntimeError(f"11b: {len(rig)} rig views for {n_views}")
    want = n_views * (torch.device(dev).type == "cuda")
    if survey_launches["raster_tiles"] < want:
        raise RuntimeError(f"11b: survey launches {survey_launches} for {n_views} views")
    if launches["raster_tiles"] < want or launches["face_class_counts"] < want:
        raise RuntimeError(f"11b: launches {launches} for {n_views} views")
    _demand_front("11b", launches, want)
    _demand_front("11b survey", survey_launches, want)
    face_classes = find_argmax_nonzero_value(torch.as_tensor(averaged)).numpy()
    truth = survey["face_labels"].astype(float)
    seen = np.isfinite(face_classes)
    accuracy = float(np.mean(face_classes[seen] == truth[seen]))
    observed = sorted(set(np.unique(face_classes[seen]).astype(int))
                      & set(range(1, survey["n_classes"])))
    if seen.sum() <= 0.5 * len(truth) or accuracy != 1.0 or len(observed) < 2:
        raise RuntimeError(f"11b: {int(seen.sum())} of {len(truth)} faces seen, accuracy "
                           f"{accuracy}, canopy classes {observed}")
    label0 = read_image_or_numpy(survey["prediction_folder"] / rig.image_filenames[0].name)
    _held_vs_plain("11b", mesh, rig, 0, cfg, use_dist=False,
                   cls=torch.as_tensor(np.where(label0 == 255, -1, label0).astype(np.int32),
                                       device=dev),
                   n_classes=survey["n_classes"])
    _line("11b", stations=n_stations, views=n_views, sensor=sensor, pano=list(pano),
          faces=mesh.n_faces, survey_caps=list(stats["caps"]), census=census,
          caps=list(caps),
          resample_s=[round(t, 4) for t in stats["resample_s"]],
          resample_s_mean=round(statistics.mean(stats["resample_s"]), 4),
          write_s=round(stats["write_s"], 4), render_s=round(stats["render_s"], 4),
          build_s=round(build_s, 4), aggregate_s=round(aggregate_s, 4),
          views_per_s=round(n_views / aggregate_s, 3), seen_faces=int(seen.sum()),
          accuracy=accuracy, canopy_classes=observed, view0_equal_plain=True,
          overflow=0, survey_launches=survey_launches, launches=launches, card=card)
    return launches


def _composite_phase(folder, survey, c2ws, sensors, sensor_ids, caps_r, dev, card=None,
                     n_views=COMPOSITE_VIEWS, width=W, height=H, res_m=None):
    """Phase 11c: ``render_labels(make_composites=True, vis=True)`` on phase
    5's mesh and labels for ``n_views`` views with PNG raw images (each
    composite equal to the plain composite of its mask and image), then
    ``visualize`` on the same mesh with the HTML export and a screenshot:
    with the faces' ids as the texture its value map is the ortho
    pix2face, held against the float64 oracle as phase 9b holds it.
    Returns the launches."""
    folder = Path(folder) / "composites"
    rng = np.random.default_rng(12)
    names = [f"view_{k:02d}.png" for k in range(n_views)]
    t0 = time.perf_counter()
    for name in names:
        write_image(folder / "images" / name,
                    rng.integers(0, 256, (height, width, 3), dtype=np.uint8))
    images_s = time.perf_counter() - t0
    cameras_file = folder / "cameras.xml"
    _write_cameras(cameras_file, c2ws[:n_views], sensors, sensor_ids[:n_views], width,
                   height)
    on = {} if torch.device(dev).type == "cuda" else {"device": dev}
    _reset_launches()
    t0 = time.perf_counter()
    mesh, _ = render_labels(survey["mesh_file"], cameras_file, folder / "images",
                            texture=survey["labels_file"], texture_column_name="species",
                            render_savefolder=folder / "renders", make_composites=True,
                            vis=True, raster_config=RasterConfig(caps=caps_r), **on)
    render_s = time.perf_counter() - t0
    launches = _launches()
    if launches["raster_tiles"] != n_views * (not on):
        raise RuntimeError(f"11c: launches {launches} for {n_views} views")
    _demand_front("11c", launches, n_views * (not on))
    comp_ms = []
    for name in names:
        mask = read_image_or_numpy(folder / "renders" / name).astype(float)
        mask[mask == 255] = np.nan
        raw = read_image_or_numpy(folder / "images" / name)
        t0 = time.perf_counter()
        plain = composite_to_uint8(create_composite(raw, mask, mesh.IDs_to_labels))
        comp_ms.append((time.perf_counter() - t0) * 1e3)
        got = read_image_or_numpy(folder / "renders" / (Path(name).stem + "_composite.png"))
        if not np.array_equal(got, plain):
            raise RuntimeError(f"11c: {name}'s composite differs from the plain one in "
                               f"{int((got != plain).any(axis=-1).sum())} pixels")
    cams = MetashapeCameraSet(cameras_file, folder / "images")
    _held_vs_plain("11c", mesh, cams, 0, mesh.raster_config)
    # visualize: the faces' ids as the texture, so the value map is the pix2face
    res_m = ORTHO_RES_M if res_m is None else res_m
    ids_file = folder / "face_ids.npy"
    vis_mesh = TexturedMesh(survey["mesh_file"], transform_filename=survey["cameras_file"],
                            device=dev)
    np.save(ids_file, np.arange(vis_mesh.n_faces, dtype=np.float64))
    stats = {}
    _reset_launches()
    t0 = time.perf_counter()
    image = visualize(survey["mesh_file"], survey["cameras_file"], survey["image_folder"],
                      texture=ids_file, resolution_m=res_m, export_html=folder / "mesh.html",
                      screenshot_filename=folder / "visualize.png", stats=stats, **on)
    visualize_s = time.perf_counter() - t0
    for name, n in _launches().items():
        launches[name] += n
    # the tile's kernel against its plain version at the caps visualize chose
    plan = vis_mesh.ortho_plan(resolution_m=res_m)
    cfg = RasterConfig(caps=stats["caps"])
    values = stats["values"]
    p2f = np.where(np.isfinite(values), values, -1).astype(np.int32)
    tile, _ = _ortho_kernel_vs_plain(plan, cfg, timed=False)
    if not np.array_equal(tile.cpu().numpy()[:plan.height, :plan.width], p2f):
        raise RuntimeError("11c: visualize's value map is not the ortho kernel's pix2face")
    h, w = p2f.shape
    oracle = _oracle_check("11c", plan, p2f, [
        (int(h * fy), int(w * fx)) for fy, fx in ((0.5, 0.5), (0.3, 0.7), (0.7, 0.3))])
    if image.shape != (h, w, 3) or not np.array_equal(
            read_image_or_numpy(folder / "visualize.png"), image):
        raise RuntimeError("11c: the screenshot is not the returned image")
    cameras_marked = int((image == (255, 0, 0)).all(axis=-1).sum())
    html_bytes = (folder / "mesh.html").stat().st_size
    _line("11c", views=n_views, image=[height, width], images_write_s=round(images_s, 4),
          render_labels_s=round(render_s, 4),
          composite_ms=[round(t, 3) for t in comp_ms], composites_equal_plain=n_views,
          visualize=dict(shape=[h, w], res_m=res_m, census=stats["census"],
                         caps=list(stats["caps"]), seconds=round(visualize_s, 4),
                         load_s=round(stats["load_s"], 4),
                         census_s=round(stats["census_s"], 4),
                         ortho_s=round(stats["ortho_s"], 4),
                         html_s=round(stats["html_s"], 4), html_bytes=html_bytes,
                         camera_pixels=cameras_marked, oracle=oracle),
          view0_equal_plain=True, overflow=0, launches=launches, card=card)
    return launches


def _batch_phase(mesh, cams, cfg, caps_r, selection_folder, selection_picks, dev,
                 card=None, scale=SELECTION_SCALE):
    """Phase 11d: ``rasterize_batch`` over phase 3's views equal to one
    ``rasterize_triangles`` a view (pinhole, at caps covering phase 3's and
    phase 5's census), and ``determine_minimum_overlapping_images`` on 10a's
    cameras with no ``raster_config``: no raise, 10a's picks at 10a's
    census caps (``selection_picks``: 10a's (picks, caps)).  Returns the
    launches."""
    caps = tuple(max(a, b) for a, b in zip(cfg.caps, caps_r))
    cfg_b = dataclasses.replace(cfg, caps=caps)
    n = len(cams)
    batch = cams.get_camera_batch(device=dev)
    tri = mesh.get_tri_verts_device(cams)
    _reset_launches()
    p2f, batch_s = _timed(dev, lambda: rasterize_batch(
        tri, batch.world_to_cam, batch.f, batch.image_width, batch.image_height, cfg_b))
    launches = _launches()
    _demand_front("11d rasterize_batch", launches, n * (torch.device(dev).type == "cuda"))
    for i in range(n):
        one = rasterize_triangles(transform_to_camera(tri, batch.world_to_cam[i]),
                                  batch.f[i], batch.image_width, batch.image_height,
                                  cfg_b)
        if not torch.equal(one, p2f[i]):
            raise RuntimeError(f"11d: rasterize_batch view {i} differs from "
                               f"rasterize_triangles in {int((one != p2f[i]).sum())} px")
    if tuple(p2f.shape) != (n, batch.image_height, batch.image_width):
        raise RuntimeError(f"11d: rasterize_batch shape {tuple(p2f.shape)}")
    view0 = _held_vs_plain("11d", mesh, cams, 0, cfg_b)
    if not torch.equal(view0, p2f[0]):
        raise RuntimeError("11d: rasterize_batch view 0 is not the raster kernel's")
    del p2f, view0
    on = {} if torch.device(dev).type == "cuda" else {"device": dev}
    stats = {}
    _reset_launches()
    chosen, select_s = _timed(dev, lambda: determine_minimum_overlapping_images(
        selection_folder["mesh_file"], selection_folder["cameras_file"],
        Path(selection_folder["cameras_file"]).parent / "images",
        aggregate_image_scale=scale, stats=stats, **on))
    for name, k in _launches().items():
        launches[name] += k
    picks_10a, caps_10a = selection_picks
    if chosen != picks_10a or tuple(stats["caps"]) != caps_10a:
        raise RuntimeError(f"11d: default-cap picks {chosen} at caps {stats['caps']} differ "
                           f"from 10a's {picks_10a} at {caps_10a}")
    _line("11d", views=n, batch_s=round(batch_s, 4), batch_equal_singles=True,
          selection=dict(views=stats["visibility"].shape[1], scale=scale,
                         caps=list(stats["caps"]), seconds=round(select_s, 4),
                         load_s=round(stats["load_s"], 4), n_chosen=len(chosen),
                         picks_equal_10a=True, caps_equal_10a=True),
          view0_equal_plain=True, overflow=0, launches=launches, card=card)
    return launches



# -- phase 12: the example scripts, on the card against the CPU ------------------

# examples_torch/<name>.py in the order they were ported, each with the
# launches of the kernels behind the front end that its card run makes
# (counted through the plain versions on CPU tensors, the same calls):
# ``raster_tiles`` one a rasterized view (the survey's label renders
# included), ``face_class_counts`` one a counted view, ``onehot_class``
# one a one-hot stack the segmentor hands over; ``s_raster`` and
# ``face_sums`` none.  The setup and binning kernels launch at least once a
# rasterized view (more with a census: ``_demand_front``).
EXAMPLES = {
    # survey renders 8, planned run 8, streaming cross-check 8 (one-hot)
    "planned_aggregation": dict(raster_tiles=24, face_class_counts=16, onehot_class=8),
    # survey renders 6, aggregation 6 (one-hot), label_polygons' ortho 1
    "aggregate_predictions": dict(raster_tiles=13, face_class_counts=6, onehot_class=6),
    # the rig's label renders 18, aggregation 18 (one-hot)
    "undercanopy_painting": dict(raster_tiles=36, face_class_counts=18, onehot_class=18),
    # survey renders 6, save_renders 6
    "render_labels": dict(raster_tiles=12, face_class_counts=0, onehot_class=0),
    # no mesh: COLMAP parsing and triangulation only
    "colmap_detections": dict(raster_tiles=0, face_class_counts=0, onehot_class=0),
    # survey renders 6, project_detections 6 (index images)
    "project_detections": dict(raster_tiles=12, face_class_counts=6, onehot_class=0),
    # realistic 6 and label renders 6, aggregation 6 (one-hot)
    "concept_figure": dict(raster_tiles=18, face_class_counts=6, onehot_class=6),
    # survey renders 6, render_labels 6, aggregate_images 6 (one-hot),
    # visualize's ortho 1
    "end_to_end_demo": dict(raster_tiles=19, face_class_counts=6, onehot_class=6),
}
# the aggregated fractions (aggregated_face_labels.npy) of the card and the
# CPU: equal, or within a few float32 ulps at 1.0 where a sum's order differs
EXAMPLE_FRACTION_ATOL = 1e-6
# located (colmap_detections) and triangulated (end_to_end_demo) points of
# the card and the CPU, in metres
EXAMPLE_POINT_ATOL_M = 1e-6
# the triangulation's float32 ray ends (tens of metres out) of the card and
# the CPU: within 4 float32 ulps of their magnitude, where the two devices
# sum a direction's norm in another order
EXAMPLE_RAY_RTOL = 4 * 2.0 ** -23
# the bars of the JAX package's tests: tests/test_examples.py; the rig's
# recovery, tests/test_rig_e2e.py:78; the entry points,
# tests/test_entrypoints.py:39 (aggregate), :293 (masks), :307 (points)
EXAMPLE_COLMAP_MAX_ERR_M = 0.1
EXAMPLE_PLANNED_MIN_AGREE = 0.95
EXAMPLE_CONCEPT_MIN_AGREE = 0.9
EXAMPLE_E2E_MIN_RECOVERED = 0.95


def _example_run(name, out, device):
    """Run ``examples_torch.<name>.main(out)`` (``device`` None: its
    default, the card) with its printed lines captured.  Returns (the
    return value, the printed text with ``out`` and seconds masked, the
    seconds, the launches)."""
    module = importlib.import_module(f"examples_torch.{name}")
    kwargs = {} if device is None else {"device": device}
    printed = io.StringIO()
    _reset_launches()
    _sync(device or "cuda")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        value = module.main(out, **kwargs)
    _sync(device or "cuda")
    seconds = time.perf_counter() - t0
    text = printed.getvalue().replace(str(out), "OUT")
    return value, re.sub(r"\d+\.\d+s\b", "<s>", text), seconds, _launches()


def _example_printed(text, prefix, suffix=""):
    """The number between ``prefix`` and ``suffix`` on the printed line
    that holds ``prefix``."""
    line = next(ln for ln in text.splitlines() if prefix in ln)
    return float(line.split(prefix, 1)[1].split(suffix, 1)[0] if suffix
                 else line.split(prefix, 1)[1].split()[0])


def _ecef_m(lat_lon_alt):
    """(M, 3) lat, lon, altitude points as ECEF metres."""
    return crs_utils.transform_points(
        np.asarray(lat_lon_alt, dtype=np.float64).reshape(-1, 3), 4326, 4978)


def _geojson_points(path):
    """(M, 3) lat, lon, altitude of a ``multiview_detections`` points file."""
    vd = VectorData.read_file(path)
    return np.array([[g[1], g[0], alt] for g, alt in
                     zip(vd.geometries, vd.attributes["altitude"])]).reshape(-1, 3)


def _matched_gap(points, ref):
    """The largest distance from a point of ``points`` to its nearest point
    of ``ref`` (both (M, 3), metres), or inf unless that pairing is one to
    one: points may come in another order."""
    points, ref = np.asarray(points, float), np.asarray(ref, float)
    if points.shape != ref.shape:
        return math.inf
    if not len(points):
        return 0.0
    d = np.linalg.norm(points[:, None] - ref[None], axis=-1)
    if len(set(d.argmin(axis=1).tolist())) != len(points):
        return math.inf
    return float(d.min(axis=1).max())


def _communities_match(x, y):
    """Two runs' ``communities.npz``: the same partition of the rays, and
    each community's point (local, and lat/lon through ECEF where there)
    within ``EXAMPLE_POINT_ATOL_M`` of its counterpart.  Communities are
    numbered by size, so those of one size may come in another order."""
    a, b = x["ray_IDs"], y["ray_IDs"]
    if a.shape != b.shape or not np.array_equal(np.isnan(a), np.isnan(b)):
        return False
    pairs = set(zip(a[~np.isnan(a)].tolist(), b[~np.isnan(b)].tolist()))
    to_y = dict(pairs)
    if len(to_y) != len(pairs) or len(set(to_y.values())) != len(pairs):
        return False
    order = [int(to_y[c]) for c in range(len(x["community_points"]))]
    if x.files != y.files or len(order) != len(y["community_points"]):
        return False
    gap = np.abs(x["community_points"] - y["community_points"][order]).max(initial=0.0)
    if "community_points_latlon" in x.files:
        gap = max(gap, float(np.linalg.norm(
            _ecef_m(x["community_points_latlon"])
            - _ecef_m(y["community_points_latlon"][order]), axis=1).max(initial=0.0)))
    return gap <= EXAMPLE_POINT_ATOL_M


def _example_files_equal(card_dir, cpu_dir):
    """Hold every file the two runs of an example wrote against each other:
    PNGs decoded and equal, count arrays (.npy other than the fractions, a
    sparse .npz) equal, the fractions within ``EXAMPLE_FRACTION_ATOL``, the
    triangulation's cached rays (.npz) with ids equal and segment ends
    within ``EXAMPLE_RAY_RTOL`` of their magnitude, its communities by
    :func:`_communities_match`.  Returns
    (files compared, whether every fraction file was equal)."""
    card_dir, cpu_dir = Path(card_dir), Path(cpu_dir)
    card = sorted(p.relative_to(card_dir) for p in card_dir.rglob("*") if p.is_file())
    cpu = sorted(p.relative_to(cpu_dir) for p in cpu_dir.rglob("*") if p.is_file())
    if card != cpu:
        raise RuntimeError(f"card and CPU wrote other files: {sorted(set(card) ^ set(cpu))}")
    n, fractions_equal = 0, True
    for rel in card:
        a, b, detail = card_dir / rel, cpu_dir / rel, ""
        if rel.suffix == ".png":
            same = np.array_equal(read_image_or_numpy(a), read_image_or_numpy(b))
        elif rel.suffix == ".npz":
            x, y = np.load(a), np.load(b)
            if "format" in x.files:  # a sparse matrix: the detection counts
                same = _csr_equal(scipy.sparse.load_npz(a), scipy.sparse.load_npz(b))
            elif rel.name == "communities.npz":
                same = _communities_match(x, y)
            else:  # the triangulation's rays: ids exact, segment ends close
                same = x.files == y.files and all(
                    x[f].shape == y[f].shape and (
                        np.allclose(x[f], y[f], rtol=EXAMPLE_RAY_RTOL,
                                    atol=EXAMPLE_POINT_ATOL_M, equal_nan=True)
                        if x[f].dtype.kind == "f" else np.array_equal(x[f], y[f]))
                    for f in x.files)
                detail = ": " + str({f: (x[f].shape, y[f].shape, float(
                    np.nanmax(np.abs(x[f] - y[f]))) if x[f].shape == y[f].shape else None)
                    for f in x.files if f in y.files})
        elif rel.suffix == ".npy":
            x, y = np.load(a), np.load(b)
            same = x.shape == y.shape and np.array_equal(x, y, equal_nan=True)
            if not same and rel.name == "aggregated_face_labels.npy":
                fractions_equal = False
                same = (np.array_equal(np.isnan(x), np.isnan(y))
                        and np.allclose(x, y, rtol=0, atol=EXAMPLE_FRACTION_ATOL,
                                        equal_nan=True))
        else:
            continue
        if not same:
            raise RuntimeError(f"{rel}: the card's file differs from the CPU's{detail}")
        n += 1
    return n, fractions_equal


def _examples_phase(folder, card=None, device=None, names=tuple(EXAMPLES)):
    """Phase 12: each script of ``examples_torch/`` run twice through its
    ``main``, on the card (its default device) and with ``device="cpu"``
    (the plain versions of the kernels), each into its own folder.

    Card against CPU: every PNG (the survey's label renders, the masks,
    the composites, the concept figure's views, label images and panels,
    the overview) decoded and equal, ``planned_counts.npy`` and
    ``projections_to_mesh.npz`` equal, the aggregated fractions
    (``aggregated_face_labels.npy``) equal or within
    ``EXAMPLE_FRACTION_ATOL`` (the line's ``fractions_equal`` says which),
    the triangulation's cached ray ends within ``EXAMPLE_RAY_RTOL`` of
    their magnitude, located and triangulated points within
    ``EXAMPLE_POINT_ATOL_M`` in any order (the Louvain communities are
    numbered by size, and the card and the CPU may number those of one
    size apart: the same rays must make them), the return values equal and
    the printed lines equal but for seconds and the output folder.  Each quantity meets the bar of the JAX package's test
    of it.  The card's launches must equal :data:`EXAMPLES` for the kernels
    behind the front end, so no view was re-run after an overflow (the
    other routes raise on one), with the setup and binning at least once a
    rasterized view; the CPU run launches nothing.  Returns the launches
    summed over the card runs.  ``device`` (None: the card) replaces the
    card in a rehearsal on the CPU, where nothing launches; ``names`` picks
    examples."""
    total = {name: 0 for name in _launches()}
    card_s = cpu_s = 0.0
    on_card = int(device is None)  # CPU tensors launch nothing
    t12 = time.perf_counter()
    for name in names:
        want = {key: n * on_card for key, n in EXAMPLES[name].items()}
        card_dir, cpu_dir = Path(folder) / name / "card", Path(folder) / name / "cpu"
        value, text, seconds, launches = _example_run(name, card_dir, device)
        value_c, text_c, cpu_seconds, launches_c = _example_run(name, cpu_dir, "cpu")
        if any(launches_c.values()):
            raise RuntimeError(f"12 {name}: the CPU run launched {launches_c}")
        want = dict(want, s_raster=0, face_sums=0)
        if _back(launches) != want:
            raise RuntimeError(f"12 {name}: launches {launches}, expected {want}")
        _demand_front(f"12 {name}", launches, want["raster_tiles"])
        if text != text_c:
            raise RuntimeError(f"12 {name}: printed lines differ:\n{text}\n-- cpu --\n{text_c}")
        n_files, fractions_equal = _example_files_equal(card_dir, cpu_dir)
        fields = {}
        if name == "planned_aggregation":
            agree = _example_printed(text, "argmax agreement on observed faces:")
            fields = dict(agreement=agree, ok=agree >= EXAMPLE_PLANNED_MIN_AGREE)
        elif name in ("aggregate_predictions", "undercanopy_painting"):
            fields = dict(accuracy=value, ok=value == 1.0 and value_c == value)
        elif name == "render_labels":
            fields = dict(masks=value, ok=value >= 4 and value_c == value)
        elif name == "colmap_detections":
            (located, objects), (located_c, _) = value, value_c
            err = np.linalg.norm(located[:, None] - objects[None], axis=-1).min(axis=1)
            gap = _matched_gap(located, located_c)
            fields = dict(located=len(located), objects=len(objects),
                          max_err_m=float(err.max()) if len(err) else None,
                          card_cpu_max_m=gap,
                          ok=(len(located) == len(objects)
                              and float(err.max()) < EXAMPLE_COLMAP_MAX_ERR_M
                              and gap <= EXAMPLE_POINT_ATOL_M))
        elif name == "project_detections":
            fields = dict(points=value, ok=value >= 2 and value_c == value)
        elif name == "concept_figure":
            fields = dict(agreement=value, ok=value > EXAMPLE_CONCEPT_MIN_AGREE
                          and value_c == value)
        elif name == "end_to_end_demo":
            recovered = _example_printed(text, "recovered", "%") / 100
            masks = len(list((card_dir / "rendered_masks").rglob("*.png")))
            pts = [_ecef_m(_geojson_points(d / "triangulated_points.geojson"))
                   for d in (card_dir, cpu_dir)]
            gap = _matched_gap(*pts)
            fields = dict(recovered=recovered, masks=masks, points=len(pts[0]),
                          card_cpu_max_m=gap,
                          ok=(recovered > EXAMPLE_E2E_MIN_RECOVERED and masks >= 2
                              and len(pts[0]) >= 1 and gap <= EXAMPLE_POINT_ATOL_M))
        if not fields.pop("ok"):
            raise RuntimeError(f"12 {name}: {fields} misses the JAX test's bar")
        kernels = sorted(k for k, v in launches.items() if v)
        _line("12", example=name, seconds=round(seconds, 3),
              cpu_seconds=round(cpu_seconds, 3), launches=launches, kernels=kernels,
              **fields, files_equal=n_files, fractions_equal=fractions_equal,
              equal_cpu=True, overflow=0, card=card)
        card_s, cpu_s = card_s + seconds, cpu_s + cpu_seconds
        for k, v in launches.items():
            total[k] += v
    _line("12", seconds=round(time.perf_counter() - t12, 3), card_s=round(card_s, 3),
          cpu_s=round(cpu_s, 3), launches=total, card=card)
    return total


if __name__ == "__main__":
    main()
