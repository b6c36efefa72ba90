"""Exact 2D vector geometry on mesh faces: the port's own copy of
``geograypher_tpu/utils/exact_geometry.py`` (numpy only).

The reference unions millions of face triangles with GEOS for its
per-class vector export (reference utils/geometric.py:13-96
``batched_unary_union``, meshes/meshes.py:1284).  Face triangles of one
class share exact edges, so the union's boundary is exactly the set of
half-edges whose twin belongs to a different class (or to no face);
chaining those half-edges yields the region rings with vertices exactly
at mesh vertex coordinates, with no floating-point clipping.

Triangle-vs-polygon intersection areas reduce to convex clipping:
ear-clipping the polygon into triangles turns every term into a
triangle-triangle area, a 3-half-plane Sutherland-Hodgman clip of a
convex subject, vectorized over all candidate mesh faces at once
(``ear_clip``, ``clip_areas_convex``, ``polygon_overlay_areas``,
``polygon_intersection_area``); holes subtract.  Polygon labeling's exact
mode and the exact vector-vs-vector overlap are built on them.
"""

from __future__ import annotations

import typing

import numpy as np

from geograypher_tpu_torch.utils.vector import Polygon, _points_in_ring, _ring_area


# ---------------------------------------------------------------------------
# exact class-region polygons from mesh combinatorics
# ---------------------------------------------------------------------------


def _directed_edge_faces(faces: np.ndarray, n_verts: int):
    """Map every directed edge (a, b) of every face to its face id.

    Returns (sorted edge keys a*NV+b, face id per key) for binary lookup.
    In a consistently-wound manifold mesh each directed edge appears at
    most once; duplicates (non-manifold fins) keep the lowest face id,
    which only affects which neighbor a fin edge compares labels against.
    """
    f = faces.shape[0]
    a = faces.reshape(-1)
    b = faces[:, [1, 2, 0]].reshape(-1)
    keys = a.astype(np.int64) * n_verts + b
    fids = np.repeat(np.arange(f, dtype=np.int64), 3)
    order = np.argsort(keys, kind="stable")
    return keys[order], fids[order]


def class_boundary_edges(
    faces: np.ndarray,
    face_labels: np.ndarray,
    n_verts: typing.Optional[int] = None,
):
    """Directed half-edges on class-region boundaries.

    A directed edge (a, b) of face f (interior on its LEFT for CCW
    faces) is a boundary edge of class ``face_labels[f]`` iff the twin
    edge (b, a) belongs to a face of a different class or to no face.
    Unlabeled faces (nan or negative) form no regions.

    Returns (edges (E, 2) int vertex ids, edge_class (E,) int).
    """
    faces = np.asarray(faces)
    labels = np.asarray(face_labels, np.float64).reshape(-1)
    if n_verts is None:
        n_verts = int(faces.max()) + 1 if faces.size else 0
    skeys, sfids = _directed_edge_faces(faces, n_verts)

    a = faces.reshape(-1)
    b = faces[:, [1, 2, 0]].reshape(-1)
    fid = np.repeat(np.arange(faces.shape[0], dtype=np.int64), 3)
    lab = labels[fid]
    valid = np.isfinite(lab) & (lab >= 0)

    twin_keys = b.astype(np.int64) * n_verts + a
    pos = np.searchsorted(skeys, twin_keys)
    pos_c = np.clip(pos, 0, max(len(skeys) - 1, 0))
    has_twin = (pos < len(skeys)) & (
        skeys[pos_c] == twin_keys if len(skeys) else False
    )
    nb_lab = np.where(has_twin, labels[sfids[pos_c]], np.nan)
    same = has_twin & np.isfinite(nb_lab) & (nb_lab == lab)
    boundary = valid & ~same
    edges = np.stack([a[boundary], b[boundary]], axis=1)
    return edges, lab[boundary].astype(np.int64)


def _chain_rings(edges: np.ndarray, verts2d: np.ndarray):
    """Chain directed boundary edges of ONE class into closed rings.

    Successor of (a, b) is an unused boundary edge (b, c).  At pinch
    vertices (several outgoing edges) the successor is chosen by turning
    angle — the most-clockwise continuation keeps each traced ring
    simple (interior stays on the left).  Returns a list of (K, 2)
    vertex-coordinate rings (not explicitly closed).
    """
    n = edges.shape[0]
    if n == 0:
        return []
    order = np.argsort(edges[:, 0], kind="stable")
    starts_sorted = edges[order, 0]
    # for each edge, candidate successors = edges starting at its head
    lo = np.searchsorted(starts_sorted, edges[:, 1], side="left")
    hi = np.searchsorted(starts_sorted, edges[:, 1], side="right")

    used = np.zeros(n, bool)
    rings = []
    for seed in range(n):
        if used[seed]:
            continue
        ring_edges = []
        e = seed
        while True:
            used[e] = True
            ring_edges.append(e)
            cands = order[lo[e]:hi[e]]
            cands = cands[~used[cands]]
            # the (used) seed edge competes as the CLOSING continuation
            # whenever the trace is back at the ring start: at a pinch
            # vertex the angle rule must be allowed to close this ring
            # rather than run into the other lobe (else two rings merge
            # into one non-simple figure-eight)
            can_close = bool(edges[seed, 0] == edges[e, 1])
            if cands.size == 0:
                # closed back to the seed — or an open chain on
                # defective input; emit what we have
                break
            if cands.size == 1 and not can_close:
                e = int(cands[0])
                continue
            # pinch vertex: pick the most-clockwise turn from the
            # incoming direction (interior on the left stays consistent)
            vin = verts2d[edges[e, 1]] - verts2d[edges[e, 0]]
            ang_in = np.arctan2(vin[1], vin[0])
            cand_list = [int(x) for x in cands] + (
                [seed] if can_close else []
            )
            ce = edges[np.asarray(cand_list)]
            vout = verts2d[ce[:, 1]] - verts2d[ce[:, 0]]
            ang = np.arctan2(vout[:, 1], vout[:, 0])
            # turn angle in (-pi, pi], pick the largest CCW turn
            # (tightest wrap around the interior on the left)
            turn = np.mod(ang - ang_in + np.pi, 2 * np.pi) - np.pi
            pick = cand_list[int(np.argmax(turn))]
            if pick == seed:
                break  # closing beats every other continuation
            e = pick
        idx = edges[np.asarray(ring_edges), 0]
        rings.append(verts2d[idx])
    return rings


def class_region_polygons(
    verts2d: np.ndarray,
    faces: np.ndarray,
    face_labels: np.ndarray,
) -> typing.Dict[int, typing.List[Polygon]]:
    """EXACT per-class region polygons of a labeled mesh (top-down).

    The vector twin of the reference's per-class ``batched_unary_union``
    over face triangles (reference utils/geometric.py:13,
    meshes/meshes.py:1284): same regions, but derived combinatorially
    from shared mesh edges — every output vertex is an exact mesh vertex
    and adjacent classes share boundaries bit-for-bit.

    Assumes a consistently-wound mesh whose top-down projection does not
    self-overlap (true for terrain heightfields; overhang geometry
    yields overlapping rings exactly as GEOS union of the projected
    triangles would).  Returns {class_id: [Polygon(outer, holes), ...]}.
    """
    verts2d = np.asarray(verts2d, np.float64)
    edges, ecls = class_boundary_edges(faces, face_labels)
    out: typing.Dict[int, typing.List[Polygon]] = {}
    # orientation of the projected faces: flip edge direction if the
    # winding is CW so interiors are on the left for the chain rule
    f0 = np.asarray(faces)
    tri = verts2d[f0]
    signed2 = (tri[:, 1, 0] - tri[:, 0, 0]) * (
        tri[:, 2, 1] - tri[:, 0, 1]
    ) - (tri[:, 2, 0] - tri[:, 0, 0]) * (tri[:, 1, 1] - tri[:, 0, 1])
    if np.median(signed2) < 0:
        edges = edges[:, ::-1]

    # each class's edges in their original order, from one stable sort
    # (not a mask over every edge per class: detection labels run to
    # thousands of classes)
    order = np.argsort(ecls, kind="stable")
    classes, first = np.unique(ecls[order], return_index=True)
    last = np.append(first[1:], len(order))
    for c, lo, hi in zip(classes, first, last):
        rings = _chain_rings(edges[order[lo:hi]], verts2d)
        outers, holes = [], []
        for r in rings:
            if r.shape[0] < 3:
                continue
            (outers if _ring_area(r) > 0 else holes).append(r)
        polys = [Polygon(o) for o in outers]
        if holes and polys:
            areas = np.array([_ring_area(o) for o in outers])
            for hring in holes:
                # a hole vertex can lie ON an outer's boundary (T-vertex;
                # the crossing-number test returns False there) — try
                # vertices until one lands strictly inside
                containing: typing.List[int] = []
                for pt in hring:
                    containing = [
                        i
                        for i, o in enumerate(outers)
                        if bool(_points_in_ring(pt[None], o)[0])
                    ]
                    if containing:
                        break
                if not containing:
                    continue  # every test vertex on an outer boundary
                best = containing[int(np.argmin(areas[containing]))]
                polys[best].holes.append(hring)
        out[int(c)] = polys
    return out


# ---------------------------------------------------------------------------
# exact triangle-vs-polygon intersection areas (convex clipping)
# ---------------------------------------------------------------------------


def ear_clip(ring: np.ndarray) -> np.ndarray:
    """Simple-polygon ring (K, 2) -> (K-2, 3, 2) triangle fan partition.

    Textbook ear clipping, O(K^2); label polygons are boundary-scale
    (tens to hundreds of vertices).  Accepts either winding.
    """
    ring = np.asarray(ring, np.float64)
    if _ring_area(ring) < 0:
        ring = ring[::-1]
    idx = list(range(ring.shape[0]))
    tris = []
    guard = 0
    while len(idx) > 3 and guard < ring.shape[0] ** 2 + 8:
        guard += 1
        n = len(idx)
        for k in range(n):
            i0, i1, i2 = idx[k - 1], idx[k], idx[(k + 1) % n]
            a, b, c = ring[i0], ring[i1], ring[i2]
            cross = (b[0] - a[0]) * (c[1] - a[1]) - (c[0] - a[0]) * (
                b[1] - a[1]
            )
            if cross <= 0:
                continue  # reflex corner
            others = np.array(
                [j for j in idx if j not in (i0, i1, i2)], np.int64
            )
            if others.size:
                tri = np.stack([a, b, c])
                inside = _points_in_ring(ring[others], tri)
                if inside.any():
                    continue
            tris.append(np.stack([a, b, c]))
            idx.pop(k)
            break
        else:
            # numerically degenerate remainder: emit a fan and stop
            break
    if len(idx) >= 3:
        for k in range(1, len(idx) - 1):
            tris.append(
                np.stack([ring[idx[0]], ring[idx[k]], ring[idx[k + 1]]])
            )
    return (
        np.stack(tris)
        if tris
        else np.zeros((0, 3, 2), np.float64)
    )


def clip_areas_convex(subject: np.ndarray, clip_tri: np.ndarray):
    """Areas of (N, 3, 2) subject triangles clipped by ONE triangle.

    Vectorized Sutherland–Hodgman against the clip triangle's three
    half-planes (subject∩clip has at most 6 vertices; buffers are padded
    to 8).  Returns (N,) float64 areas.
    """
    subject = np.asarray(subject, np.float64)
    n = subject.shape[0]
    if n == 0:
        return np.zeros((0,), np.float64)
    clip_tri = np.asarray(clip_tri, np.float64)
    if _ring_area(clip_tri) < 0:
        clip_tri = clip_tri[::-1]

    cap = 8
    pts = np.zeros((n, cap, 2))
    pts[:, :3] = subject
    cnt = np.full(n, 3, np.int64)

    for k in range(3):
        a = clip_tri[k]
        d = clip_tri[(k + 1) % 3] - a
        # signed distance (positive = inside the CCW half-plane)
        sd = (pts[..., 0] - a[0]) * d[1] - (pts[..., 1] - a[1]) * d[0]
        sd = -sd  # left of a->b is inside for CCW clip
        arange = np.arange(cap)[None, :]
        live = arange < cnt[:, None]
        inside = (sd >= 0) & live
        nxt = (arange + 1) % np.maximum(cnt, 1)[:, None]
        p_n = np.take_along_axis(pts, nxt[..., None], axis=1)
        sd_n = np.take_along_axis(sd, nxt, axis=1)
        cross = live & ((sd >= 0) != (sd_n >= 0))
        denom = sd - sd_n
        t = np.where(np.abs(denom) > 0, sd / np.where(denom == 0, 1, denom), 0.0)
        inter = pts + t[..., None] * (p_n - pts)

        # emit: for each live vertex, keep it if inside, and add the
        # intersection point if the edge crosses -> stable order scan
        emit_self = inside
        emit_inter = cross
        n_out = emit_self.sum(1) + emit_inter.sum(1)
        new_pts = np.zeros_like(pts)
        # positions via cumulative counts (vectorized two-slot scatter)
        slot0 = np.cumsum(emit_self * 1 + emit_inter * 1, axis=1)
        base = slot0 - (emit_self * 1 + emit_inter * 1)
        idx_self = np.where(emit_self, base, cap - 1)
        np.put_along_axis(
            new_pts,
            np.broadcast_to(idx_self[..., None], pts.shape).copy(),
            np.where(emit_self[..., None], pts, 0.0),
            axis=1,
        )
        idx_int = np.where(emit_inter, base + emit_self, cap - 1)
        # second write wins only its own slots: build by maximum of
        # scatter targets (slots are disjoint by construction)
        tmp = np.zeros_like(pts)
        np.put_along_axis(
            tmp,
            np.broadcast_to(idx_int[..., None], pts.shape).copy(),
            np.where(emit_inter[..., None], inter, 0.0),
            axis=1,
        )
        new_pts = new_pts + tmp
        pts = new_pts
        cnt = n_out

    # shoelace over the first cnt vertices
    arange = np.arange(cap)[None, :]
    live = arange < cnt[:, None]
    nxt = (arange + 1) % np.maximum(cnt, 1)[:, None]
    p_n = np.take_along_axis(pts, nxt[..., None], axis=1)
    terms = pts[..., 0] * p_n[..., 1] - p_n[..., 0] * pts[..., 1]
    area = 0.5 * np.where(live, terms, 0.0).sum(1)
    return np.abs(area)


def polygon_overlay_areas(
    tris: np.ndarray, polygon: Polygon
) -> np.ndarray:
    """EXACT intersection area of each (N, 3, 2) triangle with a polygon.

    The reference computes these via GEOS overlay
    (meshes/meshes.py:1226-1253); here the polygon's outer ring is
    ear-clipped and each piece clips all triangles at once; hole areas
    subtract.  Bounding-box prefiltering keeps the clip batches small.
    """
    tris = np.asarray(tris, np.float64)
    n = tris.shape[0]
    out = np.zeros(n)
    if n == 0:
        return out
    tmin = tris.min(axis=1)
    tmax = tris.max(axis=1)

    def accumulate(ring, sign):
        pieces = ear_clip(np.asarray(ring, np.float64))
        for piece in pieces:
            pmin = piece.min(axis=0)
            pmax = piece.max(axis=0)
            cand = np.nonzero(
                (tmin[:, 0] <= pmax[0])
                & (tmax[:, 0] >= pmin[0])
                & (tmin[:, 1] <= pmax[1])
                & (tmax[:, 1] >= pmin[1])
            )[0]
            if cand.size:
                out[cand] += sign * clip_areas_convex(tris[cand], piece)

    accumulate(polygon.exterior, 1.0)
    for h in polygon.holes:
        accumulate(h, -1.0)
    return np.maximum(out, 0.0)


def polygon_intersection_area(
    a: Polygon,
    b: Polygon,
    a_tris: typing.Optional[np.ndarray] = None,
    a_hole_tris: typing.Optional[list] = None,
) -> float:
    """EXACT area of intersection of two polygons (holes honored).

    Ear-clips ``a`` and sums each piece's intersection with ``b`` via
    :func:`polygon_overlay_areas`; ``a``'s holes subtract.  The building
    block of the exact vector-vs-vector confusion matrix (reference
    utils/prediction_metrics.py:95-145 computes these with GEOS).

    Callers testing one ``a`` against MANY ``b``s should pass
    ``a_tris`` / ``a_hole_tris`` (from :func:`ear_clip`) to hoist the
    O(K^2) triangulation out of their inner loop.
    """
    ax0, ay0, ax1, ay1 = a.bounds
    bx0, by0, bx1, by1 = b.bounds
    if ax1 < bx0 or bx1 < ax0 or ay1 < by0 or by1 < ay0:
        return 0.0
    if a_tris is None:
        a_tris = ear_clip(a.exterior)
    if a_hole_tris is None:
        a_hole_tris = [ear_clip(h) for h in a.holes]
    area = float(polygon_overlay_areas(a_tris, b).sum())
    for ht in a_hole_tris:
        area -= float(polygon_overlay_areas(ht, b).sum())
    return max(area, 0.0)
