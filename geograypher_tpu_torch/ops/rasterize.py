"""Triangle setup, sort-based tile binning and rasterization in PyTorch.

Port of ``geograypher_tpu/ops/rasterize.py``.  For each view: the camera
transform and triangle setup (:func:`setup_from_soa`) build per-face edge
and 1/z planes plus pixel bounding boxes; :func:`bin_triangles` assigns
each face (or block of ``bin_block`` faces) to the finest level of a
three-level tile hierarchy whose window covers its box, or to one global
list, with one sort; the raster kernel (``ops/raster_tiles.py``) resolves
the winning face per pixel; the counts kernel (``ops/face_counts.py``)
turns pix2face and a class image into per-face class counts.

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
from typing import NamedTuple, Optional, Tuple, Union

import torch

from geograypher_tpu_torch.ops.aggregate import project_image_class_counts
from geograypher_tpu_torch.ops.face_counts import face_class_counts
from geograypher_tpu_torch.ops.raster_tiles import (
    INT32_MAX,
    raster_tiles,
    tile_candidate_groups,
)
from geograypher_tpu_torch.ops.subtile import s_raster, subtile_pairs, subtile_units


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


class TriangleSetup(NamedTuple):
    """Per-view screen-space triangle data."""

    planes: torch.Tensor  # (F, 12): 3 edge planes + the 1/z plane
    bbox: torch.Tensor  # (4, F) int32 rows: first/last covered row & col
    valid: torch.Tensor  # (F,) bool


class BinnedTriangles(NamedTuple):
    """Per-level tile candidate lists.

    ``cand[l]`` is (n_tiles_l, cap_l) int32 unit ids (-1 = empty slot)
    and ``counts[l]`` the per-tile count clipped to the cap; level 3 is
    the single global list, (1, cap_3).
    """

    cand: Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
    counts: Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
    overflow: torch.Tensor  # () candidates dropped by capacity limits


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
    """Camera transform + screen projection + raster planes on (9, F) rows.

    ``planes[:, 0:9]`` are the edge coefficients (A, B, C) x 3 oriented
    positive; ``planes[:, 9:12]`` the affine 1/z plane.  Pixel (i, j) is
    covered when ``E_k(j + 0.5, i + 0.5) >= 0`` for all k.

    ``distortion`` is an optional ``(dist8, pcx, pcy)`` Brown-Conrady
    model: vertices are warped into the sensor's distorted pixel space and
    rasterized there; vertices beyond 1.3x the image-corner radius (the
    polynomial's injective domain) drop their triangle.  Triangles that
    straddle the near plane are dropped, not clipped.
    """
    ftype = tri_soa.dtype
    rot = world_to_cam[:3, :3]
    t = world_to_cam[:3, 3]
    if distortion is not None:
        from geograypher_tpu_torch.cameras.distortion import distort_normalized

        dist8, pcx, pcy = distortion
        dist8 = torch.as_tensor(dist8, dtype=ftype, device=tri_soa.device)
        # injective-domain bound: ideal radius of the image corner + 30%
        r2_lim = (
            (image_w / 2.0 + torch.abs(pcx)) ** 2
            + (image_h / 2.0 + torch.abs(pcy)) ** 2
        ) / (f * f) * 1.69
        in_domain = None

    one = torch.ones((), dtype=ftype, device=tri_soa.device)
    sx, sy, w_rows, zs = [], [], [], []
    for v in range(3):
        wx, wy, wz = tri_soa[3 * v], tri_soa[3 * v + 1], tri_soa[3 * v + 2]
        cx = rot[0, 0] * wx + rot[0, 1] * wy + rot[0, 2] * wz + t[0]
        cy = rot[1, 0] * wx + rot[1, 1] * wy + rot[1, 2] * wz + t[1]
        cz = rot[2, 0] * wx + rot[2, 1] * wy + rot[2, 2] * wz + t[2]
        inv_z = 1.0 / torch.where(cz > znear, cz, one)
        xn = cx * inv_z
        yn = cy * inv_z
        if distortion is None:
            sx.append(xn * f + image_w / 2.0)
            sy.append(yn * f + image_h / 2.0)
        else:
            xd, yd = distort_normalized(xn, yn, dist8)
            sx.append(image_w / 2.0 + pcx + xd * (f + dist8[6]) + yd * dist8[7])
            sy.append(image_h / 2.0 + pcy + yd * f)
            ok_v = xn * xn + yn * yn <= r2_lim
            in_domain = ok_v if in_domain is None else (in_domain & ok_v)
        w_rows.append(inv_z)
        zs.append(cz)

    in_front = (zs[0] > znear) & (zs[1] > znear) & (zs[2] > znear)
    if distortion is not None:
        in_front = in_front & in_domain
    x0, x1, x2 = sx
    y0, y1, y2 = sy

    def edge(xa, ya, xb, yb):
        # E(x, y) = (xb-xa)(y-ya) - (yb-ya)(x-xa)
        return -(yb - ya), xb - xa, (yb - ya) * xa - (xb - xa) * ya

    # edge k is opposite vertex k; E_k(v_k) = 2 * signed area
    a0, b0, c0 = edge(x1, y1, x2, y2)
    a1, b1, c1 = edge(x2, y2, x0, y0)
    a2, b2, c2 = edge(x0, y0, x1, y1)
    area2 = a0 * x0 + b0 * y0 + c0
    sign = torch.where(area2 < 0, -one, one)
    nondegenerate = torch.abs(area2) > 1e-12
    inv_area2 = sign / torch.where(nondegenerate, torch.abs(area2), one)

    wa = (a0 * w_rows[0] + a1 * w_rows[1] + a2 * w_rows[2]) * inv_area2
    wb = (b0 * w_rows[0] + b1 * w_rows[1] + b2 * w_rows[2]) * inv_area2
    wc = (c0 * w_rows[0] + c1 * w_rows[1] + c2 * w_rows[2]) * inv_area2
    planes = torch.stack(
        [
            a0 * sign, b0 * sign, c0 * sign,
            a1 * sign, b1 * sign, c1 * sign,
            a2 * sign, b2 * sign, c2 * sign,
            wa, wb, wc,
        ],
        dim=1,
    )

    # pixel-centre bbox: pixel j is covered only if j + 0.5 in [xmin, xmax]
    xmin = torch.minimum(torch.minimum(x0, x1), x2)
    xmax = torch.maximum(torch.maximum(x0, x1), x2)
    ymin = torch.minimum(torch.minimum(y0, y1), y2)
    ymax = torch.maximum(torch.maximum(y0, y1), y2)
    # clamp before the int32 cast: near-znear geometry can project past
    # 2^31 px, and an out-of-range float -> int cast is undefined
    big = float(2**30)
    px0 = torch.ceil(torch.clamp(xmin - 0.5, -big, big)).to(torch.int32)
    px1 = torch.floor(torch.clamp(xmax - 0.5, -big, big)).to(torch.int32)
    py0 = torch.ceil(torch.clamp(ymin - 0.5, -big, big)).to(torch.int32)
    py1 = torch.floor(torch.clamp(ymax - 0.5, -big, big)).to(torch.int32)
    nonempty = (px1 >= px0) & (py1 >= py0)
    on_screen = (px1 >= 0) & (px0 < image_w) & (py1 >= 0) & (py0 < image_h)
    px0 = torch.clamp(px0, 0, image_w - 1)
    px1 = torch.clamp(px1, 0, image_w - 1)
    py0 = torch.clamp(py0, 0, image_h - 1)
    py1 = torch.clamp(py1, 0, image_h - 1)

    valid = in_front & nondegenerate & nonempty & on_screen
    # invalid faces get the coverage-false sentinel row, so they stay
    # inert when a block-granular candidate unit carries them along
    sentinel = torch.tensor(
        [0.0, 0.0, -1.0, 0.0, 0.0, -1.0, 0.0, 0.0, -1.0, 0.0, 0.0, 0.0],
        dtype=ftype, device=tri_soa.device,
    )
    planes = torch.where(valid[:, None], planes, sentinel[None, :])
    bbox = torch.stack([py0, px0, py1, px1], dim=0)
    return TriangleSetup(planes=planes, bbox=bbox, valid=valid)


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


def expand_block_ids(cand: torch.Tensor, block: int) -> torch.Tensor:
    """(..., C) block-id lists -> (..., C*block) face ids; empty slots
    expand to -1 and ids inside a block stay ascending."""
    if block == 1:
        return cand
    offs = torch.arange(block, dtype=cand.dtype, device=cand.device)
    face = cand[..., None] * block + offs
    face = torch.where((cand >= 0)[..., None], face, -1)
    return face.reshape(cand.shape[:-1] + (cand.shape[-1] * block,))


def bin_triangles(
    setup: TriangleSetup,
    config: RasterConfig,
    image_h: int,
    image_w: int,
    return_census: bool = False,
    exclude_blocks: Optional[torch.Tensor] = None,
):
    """Assign triangles to tile candidate lists with one sort.

    Each unit (a face, or a block of ``bin_block`` faces whose box is the
    union of its valid members) goes to the finest level whose window
    covers its box -- ``l0_window`` tiles at level 0, 2x2 at levels 1-2
    -- or to the global list (level 3), giving at most wy*wx (tile key,
    unit) pairs.  The pairs are sorted on the combined int64 key
    ``key * n_units + unit``, which orders units ascending inside each
    tile as the tie rules need.

    With ``return_census`` it returns the exact per-level maximum tile
    occupancy (4,) in units instead, independent of the caps.
    ``exclude_blocks`` ((F / bin_block,) bool) drops the blocks that level
    S took (exclusive assignment: no face is resolved or counted twice),
    from the lists and from the census alike.
    """
    dev = setup.valid.device
    f_count = setup.valid.shape[0]
    grids = config.grids(image_h, image_w)
    py0, px0, py1, px1 = (setup.bbox[k] for k in range(4))
    valid = setup.valid
    bb = config.bin_block
    if bb > 1:
        if f_count % bb:
            raise ValueError(
                f"face count {f_count} not a multiple of bin_block {bb}; "
                "pad the mesh to a multiple of bin_block"
            )
        py0 = torch.where(valid, py0, INT32_MAX).reshape(-1, bb).amin(1)
        px0 = torch.where(valid, px0, INT32_MAX).reshape(-1, bb).amin(1)
        py1 = torch.where(valid, py1, -1).reshape(-1, bb).amax(1)
        px1 = torch.where(valid, px1, -1).reshape(-1, bb).amax(1)
        valid = valid.reshape(-1, bb).any(1)
        f_count //= bb
    if exclude_blocks is not None:
        valid = valid & ~exclude_blocks
    py0, px0, py1, px1 = (v.long() for v in (py0, px0, py1, px1))

    level_base = []
    base = 0
    for (nty, ntx) in grids:
        level_base.append(base)
        base += nty * ntx
    base3 = base
    total_tiles = base + 1

    w0 = config.l0_window
    wy0, wx0 = (w0, w0) if isinstance(w0, int) else w0
    wy0, wx0 = max(2, int(wy0)), max(2, int(wx0))
    per_level = []  # (ty0, ty1, tx0, tx1, fits) per level
    for lvl, scale in enumerate(config.level_scales):
        th, tw = config.tile_h * scale, config.tile_w * scale
        ty0 = torch.div(py0, th, rounding_mode="floor")
        ty1 = torch.div(py1, th, rounding_mode="floor")
        tx0 = torch.div(px0, tw, rounding_mode="floor")
        tx1 = torch.div(px1, tw, rounding_mode="floor")
        wy, wx = (wy0, wx0) if lvl == 0 else (2, 2)
        per_level.append((ty0, ty1, tx0, tx1, (ty1 - ty0 < wy) & (tx1 - tx0 < wx)))

    fits0, fits1, fits2 = (pl[4] for pl in per_level)
    if config.global_from is not None:
        # units holding any oversized-tail face go global unconditionally
        unit_last = torch.arange(f_count, device=dev) * bb + (bb - 1)
        small = unit_last < config.global_from
        fits0, fits1, fits2 = fits0 & small, fits1 & small, fits2 & small
    at_l3 = ~(fits0 | fits1 | fits2)

    def pick(i):
        a, b, c = (pl[i] for pl in per_level)
        return torch.where(fits0, a, torch.where(fits1, b, c))

    ty0_s, ty1_s, tx0_s, tx1_s = (pick(i) for i in range(4))
    lb = level_base
    base_s = torch.where(fits0, lb[0], torch.where(fits1, lb[1], lb[2]))
    ntx_s = torch.where(
        fits0, grids[0][1], torch.where(fits1, grids[1][1], grids[2][1])
    )

    keys = []
    for dy in range(wy0):
        for dx in range(wx0):
            ty = ty0_s + dy
            tx = tx0_s + dx
            in_window = (ty <= ty1_s) & (tx <= tx1_s)
            key = base_s + ty * ntx_s + tx
            if dy == 0 and dx == 0:
                key = torch.where(at_l3, base3, key)
                ok = valid & (in_window | at_l3)
            else:
                ok = valid & in_window & ~at_l3
            keys.append(torch.where(ok, key, INT32_MAX))

    units = torch.arange(f_count, device=dev)
    combined = torch.cat([k * f_count + units for k in keys])
    combined, _ = torch.sort(combined)
    sorted_keys = torch.div(combined, f_count, rounding_mode="floor")
    sorted_units = (combined - sorted_keys * f_count).to(torch.int32)

    tile_ids = torch.arange(total_tiles + 1, device=dev)
    starts = torch.searchsorted(sorted_keys, tile_ids, side="left")
    tile_counts = starts[1:] - starts[:-1]

    if return_census:
        maxes = []
        for lvl in range(3):
            n_l = grids[lvl][0] * grids[lvl][1]
            maxes.append(tile_counts[level_base[lvl]:level_base[lvl] + n_l].max())
        maxes.append(tile_counts[base3])
        return torch.stack(maxes)

    def gather_level(base, n_tiles_l, cap):
        st = starts[base:base + n_tiles_l]
        cnt = tile_counts[base:base + n_tiles_l]
        offs = torch.arange(cap, device=dev)
        idx = st[:, None] + offs[None, :]
        ok = offs[None, :] < cnt[:, None]
        vals = sorted_units[torch.clamp(idx, 0, sorted_units.shape[0] - 1)]
        over = torch.clamp(cnt - cap, min=0).sum()
        return (
            torch.where(ok, vals, -1),
            torch.clamp(cnt, max=cap).to(torch.int32),
            over,
        )

    cands, cnts, overflow = [], [], torch.zeros((), dtype=torch.int64, device=dev)
    for lvl in range(4):
        base, n_l = (
            (level_base[lvl], grids[lvl][0] * grids[lvl][1])
            if lvl < 3 else (base3, 1)
        )
        c, n, o = gather_level(base, n_l, config.caps[lvl])
        cands.append(c)
        cnts.append(n)
        overflow = overflow + o
    return BinnedTriangles(cand=tuple(cands), counts=tuple(cnts), overflow=overflow)


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
