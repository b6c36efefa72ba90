"""Exact per-class region polygons from mesh combinatorics: the port's
own copy of the class-region part of ``geograypher_tpu/utils/exact_geometry.py``
(numpy only).

The reference unions millions of face triangles with GEOS for its
per-class vector export (reference utils/geometric.py:13-96
``batched_unary_union``, meshes/meshes.py:1284).  Face triangles of one
class share exact edges, so the union's boundary is exactly the set of
half-edges whose twin belongs to a different class (or to no face);
chaining those half-edges yields the region rings with vertices exactly
at mesh vertex coordinates, with no floating-point clipping.

Not carried over yet: the triangle-vs-polygon overlay areas
(``ear_clip``, ``clip_areas_convex``, ``polygon_overlay_areas``,
``polygon_intersection_area``) that polygon labeling needs (ROADMAP A6).
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
