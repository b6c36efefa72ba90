"""Triangle setup, sort-based tile binning and rasterization in PyTorch.

Port of ``geograypher_tpu/ops/rasterize.py``.  For each view: the camera
transform and triangle setup (:func:`setup_from_soa`, the setup kernel of
``ops/tri_setup.py``) build per-face edge and 1/z planes plus pixel
bounding boxes; :func:`bin_triangles` (the binning kernels of
``ops/binning.py``) assigns each face (or block of ``bin_block`` faces) to
the finest level of a three-level tile hierarchy whose window covers its
box, or to one global list, with one sort; the raster kernel
(``ops/raster_tiles.py``) resolves the winning face per pixel; the counts
kernel (``ops/face_counts.py``) turns pix2face and a class image into
per-face class counts.

Semantics kept from the JAX package: inclusive edge tests on both
windings, depth ties to the lowest face id, triangles that straddle the
near plane are dropped, geometry outside the distortion polynomial's
injective domain is dropped, and no capacity drop is silent (``overflow``
counts every candidate a tile list could not hold).

With ``RasterConfig.subtile`` set, :func:`bin_all` first diverts small
face units to level S (``ops/subtile.py``, elementwise: no sort and no
read-back); their winners seed the raster kernel's per-pixel carry.  Not
ported: occupied-pair compaction and the TPU-only tuning fields of the JAX
``RasterConfig``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from geograypher_tpu_torch.ops.aggregate import project_image_class_counts
from geograypher_tpu_torch.ops.binning import (
    BinnedTriangles,
    expand_block_ids,
    tile_binning,
)
from geograypher_tpu_torch.ops.face_counts import face_class_counts
from geograypher_tpu_torch.ops.raster_tiles import raster_tiles, tile_candidate_groups
from geograypher_tpu_torch.ops.subtile import s_raster, subtile_pairs, subtile_units
from geograypher_tpu_torch.ops.tri_setup import TriangleSetup, triangle_setup


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Rasterizer configuration (the fields of the JAX ``RasterConfig``
    that the port reads; see ``geograypher_tpu/ops/rasterize.py:56``)."""

    tile_h: int = 8
    tile_w: int = 128
    # tile-size multipliers for levels 0..2; level 3 is the whole image
    level_scales: Tuple[int, int, int] = (1, 4, 16)
    # per-tile candidate capacity (in binning units) for levels 0..3
    caps: Tuple[int, int, int, int] = (256, 96, 48, 32)
    # candidate chunk of the plain resolve
    chunk: int = 16
    znear: float = 1e-6
    # faces per binning unit: caps count blocks of bin_block faces
    bin_block: int = 1
    # level-0 tile window (rows, cols), or an int for a square window
    l0_window: Union[int, Tuple[int, int]] = 2
    # first face id of an oversized-face tail, binned to the global level
    # (and never diverted to level S)
    global_from: Optional[int] = None
    # level-S sub-tile raster (ops/subtile.py): cell size (h, w), or None
    # to disable.  A unit of s_block consecutive faces whose box fits an
    # s_window of cells is resolved against those cells only; a bin_block
    # block leaves the tile lists when every one of its units fits.  The
    # S lists are built at each view's exact demand, so level S has no
    # capacity and can never drop a candidate.
    subtile: Optional[Tuple[int, int]] = None
    s_window: Tuple[int, int] = (3, 2)
    s_block: int = 4

    def __post_init__(self):
        if self.subtile is not None and (
            self.s_block < 1 or self.bin_block % self.s_block
        ):
            raise ValueError(
                f"level S needs bin_block ({self.bin_block}) to be a "
                f"multiple of s_block ({self.s_block})"
            )

    def grids(self, image_h: int, image_w: int):
        """Tile-grid shapes (nty, ntx) for levels 0..2."""
        out = []
        for s in self.level_scales:
            th, tw = self.tile_h * s, self.tile_w * s
            out.append((-(-image_h // th), -(-image_w // tw)))
        return out


def tri_to_soa(tri_verts: torch.Tensor) -> torch.Tensor:
    """(F, 3, 3) triangles -> (9, F) coordinate rows (x0 y0 z0 x1 ... z2)."""
    return tri_verts.reshape(tri_verts.shape[0], 9).T.contiguous()


def setup_from_soa(
    tri_soa: torch.Tensor,
    world_to_cam: torch.Tensor,
    f,
    image_w: int,
    image_h: int,
    znear: float = 1e-6,
    distortion=None,
) -> TriangleSetup:
    """Camera transform + screen projection + raster planes on (9, F) rows
    (``distortion``: an optional ``(dist8, pcx, pcy)`` Brown-Conrady
    model): :func:`~geograypher_tpu_torch.ops.tri_setup.triangle_setup`,
    the setup kernel on the card and its plain version on CPU tensors."""
    return triangle_setup(tri_soa, world_to_cam, f, image_w, image_h, znear,
                          distortion)


def transform_to_camera(
    tri_verts: torch.Tensor, world_to_cam: torch.Tensor
) -> torch.Tensor:
    """(F, 3, 3) local-frame triangles -> camera frame via one 4x4."""
    rot = world_to_cam[:3, :3]
    t = world_to_cam[:3, 3]
    flat = tri_verts.reshape(-1, 3)
    x, y, z = flat[:, 0], flat[:, 1], flat[:, 2]
    out = torch.stack(
        [
            rot[0, 0] * x + rot[0, 1] * y + rot[0, 2] * z + t[0],
            rot[1, 0] * x + rot[1, 1] * y + rot[1, 2] * z + t[1],
            rot[2, 0] * x + rot[2, 1] * y + rot[2, 2] * z + t[2],
        ],
        dim=1,
    )
    return out.reshape(tri_verts.shape)


def setup_triangles(
    tri_verts_cam: torch.Tensor,
    f,
    image_w: int,
    image_h: int,
    znear: float = 1e-6,
) -> TriangleSetup:
    """:func:`setup_from_soa` for (F, 3, 3) camera-frame triangles."""
    eye = torch.eye(4, dtype=tri_verts_cam.dtype, device=tri_verts_cam.device)
    return setup_from_soa(
        tri_to_soa(tri_verts_cam), eye, f, image_w, image_h, znear
    )


def bin_triangles(
    setup: TriangleSetup,
    config: RasterConfig,
    image_h: int,
    image_w: int,
    return_census: bool = False,
    exclude_blocks: Optional[torch.Tensor] = None,
):
    """Tile candidate lists of a view's face units (or, with
    ``return_census``, the per-level maximum tile occupancy (4,)):
    :func:`~geograypher_tpu_torch.ops.binning.tile_binning`, the binning
    kernels on the card and the plain version on CPU tensors."""
    return tile_binning(setup, config, image_h, image_w, return_census,
                        exclude_blocks)


def bin_all(setup: TriangleSetup, config: RasterConfig, image_h: int,
            image_w: int):
    """Bin at every level: (BinnedTriangles, SubtileUnits or None).

    With ``config.subtile`` set, small units go to level S first
    (``subtile_units``, elementwise) and their blocks are excluded from
    the L0..L3 lists.
    """
    if config.subtile is None:
        return bin_triangles(setup, config, image_h, image_w), None
    su = subtile_units(setup, config)
    binned = bin_triangles(setup, config, image_h, image_w,
                           exclude_blocks=su.s_mask8)
    return binned, su


def binned_face_lists(binned: BinnedTriangles, config: RasterConfig):
    """The raster kernel's inputs: per-level FACE-id lists (block ids
    expanded) and their counts in face slots."""
    if binned.face_cand is not None:  # written by the binning kernel
        return binned.face_cand, binned.face_counts
    bb = config.bin_block
    cand = tuple(expand_block_ids(c, bb).contiguous() for c in binned.cand)
    counts = tuple((n * bb).to(torch.int32).contiguous() for n in binned.counts)
    return cand, counts


def concat_candidates_for_tiles(
    binned: BinnedTriangles,
    config: RasterConfig,
    image_h: int,
    image_w: int,
) -> torch.Tensor:
    """(n_tiles0, Ctot) face-id candidate lists: each L0 tile's own list
    followed by its L1 and L2 parents' lists and the global list (-1 in
    empty slots)."""
    cand, counts = binned_face_lists(binned, config)
    groups = tile_candidate_groups(cand, counts, config, image_h, image_w)
    return torch.cat([torch.where(ok, ids, -1) for ids, ok in groups], dim=1)


def rasterize_setup(
    setup: TriangleSetup,
    config: RasterConfig,
    image_h: int,
    image_w: int,
):
    """Bin + rasterize prepared triangles -> (pix2face, binned).

    With level S on, the sub-tile raster runs first and its per-pixel
    (1/z, face) winners seed the tile raster, where a tile-list candidate
    replaces an S winner only with a strictly larger 1/z.
    """
    pix2face, binned, _ = _rasterize_levels(setup, config, image_h, image_w)
    return pix2face, binned


def _rasterize_levels(setup, config, image_h, image_w):
    """(pix2face, binned, su): :func:`rasterize_setup` with its level-S
    units (None when level S is off)."""
    binned, su = bin_all(setup, config, image_h, image_w)
    cand, counts = binned_face_lists(binned, config)
    s_init = None if su is None else s_raster(su, setup, config, image_h,
                                               image_w)
    pix2face = raster_tiles(setup.planes.contiguous(), setup.bbox.contiguous(),
                            cand, counts, config, image_h, image_w,
                            s_init=s_init)
    return pix2face, binned, su


def rasterize_and_count(
    setup: TriangleSetup,
    class_image: torch.Tensor,
    config: RasterConfig,
    image_h: int,
    image_w: int,
    n_faces: int,
    n_classes: int,
    return_overflow: bool = False,
):
    """One view's (n_faces, n_classes) float32 pixel counts from prepared
    triangles: the raster (level S first when configured), then the
    counts kernel over the finished pix2face.  With ``return_overflow``
    also the candidates the tile lists dropped (nonzero = incomplete);
    without it a nonzero overflow raises (:func:`raise_on_overflow`).
    """
    pix2face, binned = rasterize_setup(setup, config, image_h, image_w)
    counts = project_image_class_counts(pix2face, class_image, n_faces, n_classes)
    if return_overflow:
        return counts, binned.overflow
    raise_on_overflow(binned.overflow, config, "rasterize_and_count")
    return counts


def fused_view_class_counts(
    tri_soa: torch.Tensor,
    world_to_cam: torch.Tensor,
    f,
    dist8,
    pcx,
    pcy,
    class_image: torch.Tensor,
    image_w: int,
    image_h: int,
    config: RasterConfig,
    n_faces: int,
    n_classes: int,
    use_dist: bool,
):
    """One view's (counts, overflow, total_candidates).

    Camera transform + setup + binning + (with level S on) the sub-tile
    raster + the raster kernel + the counts kernel.  ``counts`` is
    (n_faces, n_classes) float32 (exact integers, counted in int32);
    ``overflow > 0`` means a tile list dropped candidates and the counts
    are incomplete -- callers must fail.  ``total_candidates`` counts the
    binned units of every list, level-S pairs included.  ``use_dist``
    rasterizes in the sensor's distorted pixel space.

    With level S on, one launch of the counts kernel over the S-seeded
    pix2face counts the S winners' pixels too: it computes what the TPU
    chain's S count kernel and face-block folds compute together.
    """
    setup = setup_from_soa(
        tri_soa, world_to_cam, f, image_w, image_h, config.znear,
        distortion=(dist8, pcx, pcy) if use_dist else None,
    )
    pix2face, binned, su = _rasterize_levels(setup, config, image_h, image_w)
    counts = face_class_counts(
        pix2face, class_image.to(torch.int32).contiguous(), n_faces, n_classes
    )
    ncand = sum(c.sum() for c in binned.counts)
    if su is not None:
        ncand = ncand + subtile_pairs(su)
    return counts.to(torch.float32), binned.overflow, ncand


def rasterize_triangles(
    tri_verts_cam: torch.Tensor,
    f,
    image_w: int,
    image_h: int,
    config: RasterConfig = RasterConfig(),
    return_overflow: bool = False,
):
    """One view's (image_h, image_w) int32 pix2face from camera-frame
    (F, 3, 3) triangles; -1 for background.  With ``return_overflow``
    also the candidates the tile lists dropped, a () tensor on the device
    (nonzero = the pix2face is incomplete), for a caller that checks many
    views with one read; without it a nonzero overflow raises
    (:func:`raise_on_overflow`), so no drop is silent."""
    setup = setup_triangles(tri_verts_cam, f, image_w, image_h, config.znear)
    pix2face, binned = rasterize_setup(setup, config, image_h, image_w)
    if return_overflow:
        return pix2face, binned.overflow
    raise_on_overflow(binned.overflow, config, "rasterize_triangles")
    return pix2face


def rasterize_batch(
    tri_verts: torch.Tensor,
    world_to_cam: torch.Tensor,
    f: torch.Tensor,
    image_w: int,
    image_h: int,
    config: RasterConfig = RasterConfig(),
) -> torch.Tensor:
    """(N, image_h, image_w) int32 pix2face of N cameras over local-frame
    (F, 3, 3) triangles, on their device; -1 for background.

    The (9, F) coordinate rows are built once for the batch
    (:func:`tri_to_soa`) and each view runs the chain of
    :func:`rasterize_triangles` on them (``world_to_cam`` (N, 4, 4), ``f``
    (N,)).  The views' overflow is read once, after the last, and a
    nonzero one raises ``ValueError`` naming the views (no drop is
    silent)."""
    soa = tri_to_soa(tri_verts)
    out = torch.empty((world_to_cam.shape[0], image_h, image_w), dtype=torch.int32,
                      device=tri_verts.device)
    overflow = []
    for i in range(world_to_cam.shape[0]):
        setup = setup_from_soa(soa, world_to_cam[i], f[i], image_w, image_h,
                               config.znear)
        out[i], binned = rasterize_setup(setup, config, image_h, image_w)
        overflow.append(binned.overflow)
    dropped = torch.stack(overflow).cpu() if overflow else torch.zeros(0)
    if dropped.any():
        views = torch.nonzero(dropped).flatten().tolist()
        raise ValueError(
            f"rasterize_batch: the tile lists of views {views} dropped "
            f"{dropped[views].tolist()} candidates at caps {tuple(config.caps)}; "
            "their pix2face is incomplete.  Raise the caps (a census sizes them)")
    return out


def raise_on_overflow(overflow: torch.Tensor, config: RasterConfig, what: str) -> None:
    """Read a view's overflow (one synchronise) and raise ``ValueError``
    naming the candidates the tile lists dropped when it is nonzero."""
    dropped = int(overflow)
    if dropped:
        raise ValueError(
            f"{what}: the tile lists dropped {dropped} candidates at caps "
            f"{tuple(config.caps)}; the pix2face is incomplete.  Raise the caps "
            "(a census sizes them), or pass return_overflow=True to read the "
            "overflow yourself")
