"""Minimal vector-geodata engine: the port's own copy of the numpy part of
``geograypher_tpu/utils/vector.py`` (which replaces shapely / geopandas).

* :class:`VectorData`: a feature collection (polygons/points + attribute
  table + EPSG) with GeoJSON, shapefile and GeoPackage reading and GeoJSON
  / GeoPackage writing (``json``, ``struct``, ``sqlite3``).
* vectorized point-in-polygon (crossing number over all rings at once).
* :func:`points_near_polygons`: which points lie within a distance of a
  set of polygons, the exact test the ROI selection uses.
* the raster-assisted polygon operations (``rasterize_polygons``,
  ``polygons_from_mask``, ``buffer_polygons``, ``union_all``), which the
  JAX package builds on cv2, on the port's numpy ``utils/polyfill.py``
  (``fillPoly``) and ``utils/contours.py`` (``findContours``, the
  elliptical ``dilate`` and ``erode``).
"""

from __future__ import annotations

import json
import math
import sqlite3
import struct
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from geograypher_tpu_torch.constants import PATH_TYPE
from geograypher_tpu_torch.utils import crs as crs_utils
from geograypher_tpu_torch.utils.contours import dilate, ellipse_kernel, erode, find_contours
from geograypher_tpu_torch.utils.files import ensure_containing_folder
from geograypher_tpu_torch.utils.parsing import crs_from_srs_text
from geograypher_tpu_torch.utils.polyfill import fill_poly


class Polygon:
    """Polygon with exterior ring + holes, as (N, 2) float arrays of
    (x, y) — for EPSG:4326 that is (lon, lat) GeoJSON axis order."""

    __slots__ = ("exterior", "holes")

    def __init__(self, exterior, holes=()):
        self.exterior = np.asarray(exterior, dtype=np.float64)
        self.holes = [np.asarray(h, dtype=np.float64) for h in holes]

    @property
    def bounds(self) -> Tuple[float, float, float, float]:
        xs, ys = self.exterior[:, 0], self.exterior[:, 1]
        return float(xs.min()), float(ys.min()), float(xs.max()), float(ys.max())

    @property
    def area(self) -> float:
        a = _ring_area(self.exterior)
        return abs(a) - sum(abs(_ring_area(h)) for h in self.holes)

    @property
    def centroid(self) -> Tuple[float, float]:
        c = _ring_centroid(self.exterior)
        return float(c[0]), float(c[1])

    def contains_points(self, pts: np.ndarray) -> np.ndarray:
        """Vectorized point-in-polygon for (N, 2) points."""
        inside = _points_in_ring(pts, self.exterior)
        for h in self.holes:
            inside &= ~_points_in_ring(pts, h)
        return inside

    def buffer(self, dist: float, resolution: int = 8) -> "Polygon":
        """Approximate Minkowski buffer via raster dilation/erosion."""
        polys = buffer_polygons([self], dist, resolution=resolution)
        return polys[0] if polys else Polygon(np.zeros((0, 2)))


def _ring_area(ring: np.ndarray) -> float:
    x, y = ring[:, 0], ring[:, 1]
    return 0.5 * float(
        np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)
    )


def _ring_centroid(ring: np.ndarray) -> np.ndarray:
    x, y = ring[:, 0], ring[:, 1]
    xn, yn = np.roll(x, -1), np.roll(y, -1)
    cross = x * yn - xn * y
    a = np.sum(cross) / 2.0
    if abs(a) < 1e-12:
        return ring.mean(axis=0)
    cx = np.sum((x + xn) * cross) / (6 * a)
    cy = np.sum((y + yn) * cross) / (6 * a)
    return np.array([cx, cy])


def _points_in_ring(pts: np.ndarray, ring: np.ndarray) -> np.ndarray:
    """Crossing-number test, vectorized over points x edges."""
    pts = np.asarray(pts, dtype=np.float64)
    x, y = pts[:, 0:1], pts[:, 1:2]  # (N, 1)
    x0, y0 = ring[:-1, 0][None], ring[:-1, 1][None]  # (1, E)
    x1, y1 = ring[1:, 0][None], ring[1:, 1][None]
    if not (ring[0] == ring[-1]).all():
        x0 = np.concatenate([x0, ring[-1:, 0][None]], axis=1)
        y0 = np.concatenate([y0, ring[-1:, 1][None]], axis=1)
        x1 = np.concatenate([x1, ring[:1, 0][None]], axis=1)
        y1 = np.concatenate([y1, ring[:1, 1][None]], axis=1)
    cond = (y0 <= y) != (y1 <= y)
    with np.errstate(divide="ignore", invalid="ignore"):
        xint = x0 + (y - y0) * (x1 - x0) / (y1 - y0)
    crossings = np.sum(cond & (x < xint), axis=1)
    return (crossings % 2) == 1


class VectorData:
    """A feature table: geometries + per-feature attributes + EPSG code.

    The minimal stand-in for a GeoDataFrame in this framework's workflows.
    """

    def __init__(
        self,
        geometries: Sequence[Union[Polygon, np.ndarray]],
        attributes: Optional[Dict[str, list]] = None,
        epsg: Optional[int] = None,
    ):
        self.geometries = list(geometries)
        self.attributes: Dict[str, list] = {
            k: list(v) for k, v in (attributes or {}).items()
        }
        for k, v in self.attributes.items():
            if len(v) != len(self.geometries):
                raise ValueError(f"attribute {k} length mismatch")
        self.epsg = int(epsg) if epsg is not None else None

    def __len__(self):
        return len(self.geometries)

    def __getitem__(self, column: str) -> list:
        return self.attributes[column]

    @property
    def is_points(self) -> bool:
        return bool(self.geometries) and isinstance(
            self.geometries[0], np.ndarray
        )

    def total_bounds(self) -> Tuple[float, float, float, float]:
        bs = []
        for g in self.geometries:
            if isinstance(g, Polygon):
                bs.append(g.bounds)
            else:
                p = np.asarray(g).reshape(-1, 2)
                bs.append((p[:, 0].min(), p[:, 1].min(), p[:, 0].max(), p[:, 1].max()))
        bs = np.asarray(bs)
        return (
            float(bs[:, 0].min()),
            float(bs[:, 1].min()),
            float(bs[:, 2].max()),
            float(bs[:, 3].max()),
        )

    def to_crs(self, epsg: int) -> "VectorData":
        if self.epsg is None:
            raise ValueError("VectorData has no CRS")
        if int(epsg) == self.epsg:
            return self
        geoms = []
        for g in self.geometries:
            if isinstance(g, Polygon):
                geoms.append(
                    Polygon(
                        _tx_ring(g.exterior, self.epsg, epsg),
                        [_tx_ring(h, self.epsg, epsg) for h in g.holes],
                    )
                )
            else:
                geoms.append(_tx_ring(np.asarray(g).reshape(-1, 2), self.epsg, epsg))
        return VectorData(geoms, self.attributes, epsg)

    def ensure_projected(self) -> "VectorData":
        """Project geographic data to the local UTM zone."""
        if self.epsg is None:
            return self
        try:
            if crs_utils.crs_is_projected(self.epsg):
                return self
        except ValueError:
            # unknown EPSG: can't transform it anyway; pass through
            return self
        g0 = self.geometries[0]
        if isinstance(g0, Polygon):
            lon, lat = g0.centroid
        else:
            pt = np.asarray(g0).reshape(-1, 2)[0]
            lon, lat = pt[0], pt[1]
        utm = crs_utils.utm_epsg_for(lat, lon)
        return self.to_crs(utm)

    def contains_points(self, pts: np.ndarray) -> np.ndarray:
        """(n_pts,) index of the first polygon containing each point, -1 if
        none.  Bbox-prefiltered crossing-number tests."""
        pts = np.asarray(pts, dtype=np.float64)
        out = np.full(pts.shape[0], -1, dtype=np.int64)
        for i, g in enumerate(self.geometries):
            if not isinstance(g, Polygon):
                continue
            x0, y0, x1, y1 = g.bounds
            cand = (
                (out < 0)
                & (pts[:, 0] >= x0)
                & (pts[:, 0] <= x1)
                & (pts[:, 1] >= y0)
                & (pts[:, 1] <= y1)
            )
            if not cand.any():
                continue
            inside = g.contains_points(pts[cand])
            idx = np.where(cand)[0][inside]
            out[idx] = i
        return out

    # -- IO -----------------------------------------------------------------

    @staticmethod
    def read_file(path: PATH_TYPE) -> "VectorData":
        path = Path(path)
        suffix = path.suffix.lower()
        if suffix in (".geojson", ".json"):
            return _read_geojson(path)
        if suffix == ".gpkg":
            return _read_gpkg(path)
        if suffix == ".shp":
            return _read_shapefile(path)
        raise ValueError(
            f"Unsupported vector format {suffix}; "
            "supported: .geojson/.json/.gpkg/.shp"
        )

    def to_file(self, path: PATH_TYPE) -> None:
        path = Path(path)
        ensure_containing_folder(path)
        if path.suffix.lower() == ".gpkg":
            _write_gpkg(path, self)
            return
        if path.suffix.lower() not in (".geojson", ".json"):
            raise ValueError(
                "Writing supports GeoJSON (.geojson/.json) and GeoPackage (.gpkg)"
            )
        feats = []
        for i, g in enumerate(self.geometries):
            props = {k: _jsonable(v[i]) for k, v in self.attributes.items()}
            if isinstance(g, Polygon):
                rings = [g.exterior.tolist()] + [h.tolist() for h in g.holes]
                geom = {"type": "Polygon", "coordinates": rings}
            else:
                pt = np.asarray(g).reshape(-1)
                geom = {"type": "Point", "coordinates": pt.tolist()}
            feats.append(
                {"type": "Feature", "geometry": geom, "properties": props}
            )
        doc = {"type": "FeatureCollection", "features": feats}
        if self.epsg is not None:
            doc["crs"] = {
                "type": "name",
                "properties": {"name": f"urn:ogc:def:crs:EPSG::{self.epsg}"},
            }
        Path(path).write_text(json.dumps(doc))


def _jsonable(v):
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if isinstance(v, float) and math.isnan(v):
        return None
    return v


def _tx_ring(ring: np.ndarray, src: int, dst: int) -> np.ndarray:
    pts3 = np.concatenate([ring, np.zeros((ring.shape[0], 1))], axis=1)
    # vector files store geographic coords as (lon, lat) for EVERY
    # geographic datum (4326/4269/4258...), but transform_points follows
    # the pyproj axis convention of (lat, lon) columns for all of them
    if src in crs_utils.GEOGRAPHIC_EPSG:
        pts3 = pts3[:, [1, 0, 2]]  # file lon/lat -> transform lat/lon
    out = crs_utils.transform_points(pts3, src, dst)
    if dst in crs_utils.GEOGRAPHIC_EPSG:
        out = out[:, [1, 0, 2]]
    return out[:, :2]


def _read_geojson(path: Path) -> VectorData:
    doc = json.loads(Path(path).read_text())
    epsg = 4326
    crs_field = doc.get("crs")
    if crs_field:
        name = str(crs_field.get("properties", {}).get("name", ""))
        # "urn:ogc:def:crs:EPSG:8.9:32611" / "EPSG:32611" / "CRS84":
        # the code is the TRAILING numeric token (concatenating every
        # digit would turn versioned URNs into bogus codes)
        tail = name.split(":")[-1]
        if tail.upper() == "CRS84":
            epsg = 4326
        elif tail.isdigit():
            epsg = int(tail)
    geoms: List[Union[Polygon, np.ndarray]] = []
    attrs: Dict[str, list] = {}
    feats = doc["features"] if doc.get("type") == "FeatureCollection" else [doc]
    for fi, feat in enumerate(feats):
        geom = feat["geometry"]
        parts = []
        if geom["type"] == "Polygon":
            parts = [geom["coordinates"]]
        elif geom["type"] == "MultiPolygon":
            parts = geom["coordinates"]
        elif geom["type"] == "Point":
            parts = None
            geoms.append(np.asarray(geom["coordinates"], dtype=np.float64))
            _append_attrs(attrs, feat.get("properties") or {}, len(geoms))
            continue
        else:
            continue
        for rings in parts:
            geoms.append(
                Polygon(np.asarray(rings[0]), [np.asarray(r) for r in rings[1:]])
            )
            _append_attrs(attrs, feat.get("properties") or {}, len(geoms))
    return VectorData(geoms, attrs, epsg)


def _append_attrs(attrs: Dict[str, list], props: dict, n: int):
    for k in set(attrs) | set(props):
        attrs.setdefault(k, [None] * (n - 1))
        attrs[k].append(props.get(k))
    for k in attrs:
        if len(attrs[k]) < n:
            attrs[k] += [None] * (n - len(attrs[k]))


# -- GeoPackage (sqlite + WKB) ------------------------------------------------


def _read_dbf(path: Path) -> List[dict]:
    """Per-record attribute dicts from a dBase III (.dbf) sidecar.

    Minimal parser for the subset shapefile writers emit: C (text),
    N/F (numeric), L (logical), D (date-as-text) field types.
    """
    buf = path.read_bytes()
    n_records = struct.unpack_from("<I", buf, 4)[0]
    header_size, record_size = struct.unpack_from("<HH", buf, 8)
    fields = []
    pos = 32
    while pos < header_size - 1 and buf[pos] != 0x0D:
        name = buf[pos:pos + 11].split(b"\x00")[0].decode("ascii", "replace")
        ftype = chr(buf[pos + 11])
        flen = buf[pos + 16]
        fdec = buf[pos + 17]
        fields.append((name, ftype, flen, fdec))
        pos += 32

    def convert(raw: bytes, ftype: str, fdec: int):
        text = raw.decode("latin-1").strip()
        if ftype in ("N", "F"):
            if not text:
                return None
            try:
                return float(text) if (fdec or ftype == "F") else int(text)
            except ValueError:
                return None
        if ftype == "L":
            return text.upper() in ("T", "Y")
        return text

    records = []
    pos = header_size
    for _ in range(n_records):
        if pos + record_size > len(buf):
            break
        if buf[pos:pos + 1] == b"*":  # deleted record
            pos += record_size
            continue
        rec, off = {}, pos + 1
        for name, ftype, flen, fdec in fields:
            rec[name] = convert(buf[off:off + flen], ftype, fdec)
            off += flen
        records.append(rec)
        pos += record_size
    return records


def _shp_rings_to_polygons(
    parts: List[np.ndarray],
) -> List[Polygon]:
    """ESRI ring convention: exterior rings wind clockwise (negative
    shoelace area in y-up coords); holes counter-clockwise, following
    their exterior."""

    def signed_area(r):
        x, y = r[:, 0], r[:, 1]
        return 0.5 * float(
            np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)
        )

    polys: List[Polygon] = []
    current_ext, current_holes = None, []
    for ring in parts:
        if signed_area(ring) <= 0 or current_ext is None:  # exterior
            if current_ext is not None:
                polys.append(Polygon(current_ext, current_holes))
            current_ext, current_holes = ring, []
        else:
            current_holes.append(ring)
    if current_ext is not None:
        polys.append(Polygon(current_ext, current_holes))
    return polys


def _read_shapefile(path: Path) -> VectorData:
    """Minimal ESRI Shapefile reader (.shp + optional .dbf/.prj sidecars),
    covering the shape types geograypher workflows encounter: Point(Z/M),
    MultiPoint, Polygon(Z/M)."""
    buf = Path(path).read_bytes()
    if struct.unpack_from(">i", buf, 0)[0] != 9994:
        raise ValueError(f"{path} is not an ESRI shapefile")

    geoms_per_record: List[list] = []
    pos = 100
    while pos + 8 <= len(buf):
        content_words = struct.unpack_from(">i", buf, pos + 4)[0]
        rec = buf[pos + 8:pos + 8 + content_words * 2]
        pos += 8 + content_words * 2
        stype = struct.unpack_from("<i", rec, 0)[0]
        base = stype % 10  # Z (x5 offsets 11/13/15/18) and M types share layout
        if stype == 0:  # null shape
            geoms_per_record.append([])
        elif base == 1 and stype in (1, 11, 21):  # Point / PointZ / PointM
            x, y = struct.unpack_from("<2d", rec, 4)
            # PointZ's z is dropped: every geometry consumer here is 2-D
            # (total_bounds/to_crs reshape(-1, 2))
            geoms_per_record.append([np.asarray([x, y], np.float64)])
        elif base == 8:  # MultiPoint(Z/M)
            n_pts = struct.unpack_from("<i", rec, 36)[0]
            pts = np.frombuffer(rec, "<f8", 2 * n_pts, 40).reshape(-1, 2)
            geoms_per_record.append([p.copy() for p in pts])
        elif base in (3, 5):  # PolyLine/Polygon (Z/M)
            n_parts, n_pts = struct.unpack_from("<2i", rec, 36)
            part_idx = list(
                struct.unpack_from(f"<{n_parts}i", rec, 44)
            ) + [n_pts]
            pts = np.frombuffer(
                rec, "<f8", 2 * n_pts, 44 + 4 * n_parts
            ).reshape(-1, 2)
            rings = [
                pts[part_idx[i]:part_idx[i + 1]].copy()
                for i in range(n_parts)
                if part_idx[i + 1] - part_idx[i] >= (4 if base == 5 else 2)
            ]
            if base == 5:
                geoms_per_record.append(_shp_rings_to_polygons(rings))
            else:
                # polylines are stored as open vertex arrays
                geoms_per_record.append(list(rings))
        else:
            raise ValueError(f"Unsupported shapefile shape type {stype}")

    dbf = Path(path).with_suffix(".dbf")
    records = _read_dbf(dbf) if dbf.exists() else [{}] * len(geoms_per_record)

    epsg = None
    prj = Path(path).with_suffix(".prj")
    if prj.exists():
        epsg = crs_from_srs_text(prj.read_text())

    geoms: List[Union[Polygon, np.ndarray]] = []
    attrs: Dict[str, list] = {}
    for rec_geoms, rec_attrs in zip(geoms_per_record, records):
        for g in rec_geoms:
            geoms.append(g)
            _append_attrs(attrs, rec_attrs, len(geoms))
    return VectorData(geoms, attrs, epsg)


def _read_gpkg(path: Path) -> VectorData:
    con = sqlite3.connect(str(path))
    try:
        row = con.execute(
            "SELECT table_name, srs_id FROM gpkg_geometry_columns LIMIT 1"
        ).fetchone()
        if row is None:
            raise ValueError("No geometry table in GeoPackage")
        table, srs_id = row
        geom_col = con.execute(
            "SELECT column_name FROM gpkg_geometry_columns WHERE table_name=?",
            (table,),
        ).fetchone()[0]
        cols = [r[1] for r in con.execute(f'PRAGMA table_info("{table}")')]
        attr_cols = [c for c in cols if c != geom_col]
        sel = ", ".join(f'"{c}"' for c in ([geom_col] + attr_cols))
        geoms: List[Union[Polygon, np.ndarray]] = []
        attrs: Dict[str, list] = {c: [] for c in attr_cols}
        for rec in con.execute(f'SELECT {sel} FROM "{table}"'):
            blob = rec[0]
            if blob is None:
                continue
            for g in _parse_gpkg_blob(blob):
                geoms.append(g)
                for c, v in zip(attr_cols, rec[1:]):
                    attrs[c].append(v)
        return VectorData(geoms, attrs, int(srs_id))
    finally:
        con.close()


def _parse_gpkg_blob(blob: bytes):
    # GeoPackage binary header: magic 'GP', version, flags, srs, envelope
    if blob[:2] != b"GP":
        raise ValueError("Bad GPKG geometry blob")
    flags = blob[3]
    env_code = (flags >> 1) & 0x7
    env_len = {0: 0, 1: 32, 2: 48, 3: 48, 4: 64}[env_code]
    return _parse_wkb(blob[8 + env_len :])


def _parse_wkb(buf: bytes):
    geoms = []
    _parse_wkb_into(buf, 0, geoms)
    return geoms


def _parse_wkb_into(buf: bytes, off: int, out: list) -> int:
    endian = "<" if buf[off] == 1 else ">"
    (gtype,) = struct.unpack_from(endian + "I", buf, off + 1)
    off += 5
    base = gtype % 1000
    has_z = gtype >= 1000
    dim = 3 if has_z else 2
    if base == 1:  # Point
        vals = struct.unpack_from(endian + "d" * dim, buf, off)
        out.append(np.asarray(vals[:2]))
        return off + 8 * dim
    if base == 3:  # Polygon
        (nrings,) = struct.unpack_from(endian + "I", buf, off)
        off += 4
        rings = []
        for _ in range(nrings):
            (npts,) = struct.unpack_from(endian + "I", buf, off)
            off += 4
            vals = np.frombuffer(
                buf, dtype=endian + "f8", count=npts * dim, offset=off
            ).reshape(npts, dim)
            rings.append(vals[:, :2].copy())
            off += 8 * dim * npts
        out.append(Polygon(rings[0], rings[1:]))
        return off
    if base in (4, 6, 7):  # Multi* / collection
        (n,) = struct.unpack_from(endian + "I", buf, off)
        off += 4
        for _ in range(n):
            off = _parse_wkb_into(buf, off, out)
        return off
    raise ValueError(f"Unsupported WKB geometry type {gtype}")


def _wkb_geometry(geom) -> bytes:
    """Serialize a Polygon or point to little-endian WKB."""
    if isinstance(geom, Polygon):
        rings = [geom.exterior] + list(geom.holes)
        out = struct.pack("<BII", 1, 3, len(rings))
        for ring in rings:
            ring = np.asarray(ring, dtype=np.float64)
            if len(ring) and not (ring[0] == ring[-1]).all():
                ring = np.concatenate([ring, ring[:1]], axis=0)
            out += struct.pack("<I", len(ring))
            out += ring.astype("<f8").tobytes()
        return out
    pt = np.asarray(geom, dtype=np.float64).reshape(-1)
    return struct.pack("<BI", 1, 1) + struct.pack("<dd", pt[0], pt[1])


def _write_gpkg(path: Path, vd: "VectorData", table: str = "features") -> None:
    """Write a minimal standards-shaped GeoPackage (sqlite + WKB blobs +
    the required gpkg_* metadata tables)."""
    path.unlink(missing_ok=True)
    srs_id = vd.epsg if vd.epsg is not None else 0
    is_points = vd.is_points
    gtype = "POINT" if is_points else "POLYGON"
    con = sqlite3.connect(str(path))
    try:
        con.execute("PRAGMA application_id = 0x47504B47")  # 'GPKG'
        con.execute("PRAGMA user_version = 10300")
        con.execute(
            "CREATE TABLE gpkg_spatial_ref_sys (srs_name TEXT NOT NULL, "
            "srs_id INTEGER PRIMARY KEY, organization TEXT NOT NULL, "
            "organization_coordsys_id INTEGER NOT NULL, definition TEXT "
            "NOT NULL, description TEXT)"
        )
        con.execute(
            "INSERT INTO gpkg_spatial_ref_sys VALUES (?, ?, 'EPSG', ?, "
            "'', NULL)",
            (f"EPSG:{srs_id}", srs_id, srs_id),
        )
        con.execute(
            "CREATE TABLE gpkg_contents (table_name TEXT PRIMARY KEY, "
            "data_type TEXT NOT NULL, identifier TEXT UNIQUE, description "
            "TEXT DEFAULT '', last_change DATETIME, min_x DOUBLE, min_y "
            "DOUBLE, max_x DOUBLE, max_y DOUBLE, srs_id INTEGER)"
        )
        bounds = vd.total_bounds() if len(vd) else (0, 0, 0, 0)
        con.execute(
            "INSERT INTO gpkg_contents VALUES (?, 'features', ?, '', "
            "datetime('now'), ?, ?, ?, ?, ?)",
            (table, table, bounds[0], bounds[1], bounds[2], bounds[3], srs_id),
        )
        con.execute(
            "CREATE TABLE gpkg_geometry_columns (table_name TEXT NOT NULL, "
            "column_name TEXT NOT NULL, geometry_type_name TEXT NOT NULL, "
            "srs_id INTEGER NOT NULL, z TINYINT NOT NULL, m TINYINT NOT "
            "NULL, CONSTRAINT pk_geom_cols PRIMARY KEY (table_name, "
            "column_name))"
        )
        con.execute(
            "INSERT INTO gpkg_geometry_columns VALUES (?, 'geom', ?, ?, 0, 0)",
            (table, gtype, srs_id),
        )
        attr_cols = list(vd.attributes)
        col_defs = "".join(f', "{c}" TEXT' for c in attr_cols)
        con.execute(
            f'CREATE TABLE "{table}" (fid INTEGER PRIMARY KEY '
            f"AUTOINCREMENT, geom BLOB{col_defs})"
        )
        header = b"GP" + bytes([0, 1]) + struct.pack("<i", srs_id)
        for i, g in enumerate(vd.geometries):
            blob = header + _wkb_geometry(g)
            vals = [
                None if vd.attributes[c][i] is None else str(
                    _jsonable(vd.attributes[c][i])
                )
                for c in attr_cols
            ]
            placeholders = ", ".join(["?"] * (1 + len(attr_cols)))
            con.execute(
                f'INSERT INTO "{table}" (geom{"".join(", " + chr(34) + c + chr(34) for c in attr_cols)}) '
                f"VALUES ({placeholders})",
                [blob] + vals,
            )
        con.commit()
    finally:
        con.close()


# -- distance to polygons -------------------------------------------------------


def _ring_edges(ring: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(E, 2) start and end points of a ring's edges, closed if it is not."""
    ring = np.asarray(ring, dtype=np.float64)
    if len(ring) and not (ring[0] == ring[-1]).all():
        ring = np.concatenate([ring, ring[:1]], axis=0)
    return ring[:-1], ring[1:]


def _distance_to_edges(pts: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,) distance of every point to the nearest of the segments a-b."""
    ab = b - a  # (E, 2)
    ap = pts[:, None, :] - a[None]  # (N, E, 2)
    length2 = (ab * ab).sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(length2 > 0, (ap * ab[None]).sum(axis=2) / length2, 0.0)
    off = ap - np.clip(t, 0.0, 1.0)[..., None] * ab[None]
    return np.sqrt((off * off).sum(axis=2)).min(axis=1)


def points_near_polygons(
    polygons: Sequence[Polygon],
    pts: np.ndarray,
    dist: float = 0.0,
    chunk: int = 32768,
) -> np.ndarray:
    """(N,) bool: which points lie inside the polygons buffered by
    ``dist`` (a negative ``dist`` erodes).

    An exact test in numpy: a point is kept when it lies inside a polygon
    or within ``dist`` of one of its edges (for ``dist < 0``: inside, and
    at least ``-dist`` from every edge).  The JAX package instead burns
    the polygons into a 2048 x 2048 grid, dilates it with an ellipse and
    traces the contours back (``buffer_polygons``, cv2), which the
    machine with the card cannot run.  The two agree on every point whose
    distance to the polygons differs from ``dist`` by more than 2 cells
    of that grid (``max extent / 2048``) where the polygons' padded bounds
    are square; where they are not, the grid's cells are shorter along the
    shorter side, the raster buffer reaches only ``dist * short / long``
    that way, and points between that and ``dist`` may differ too.
    """
    pts = np.asarray(pts, dtype=np.float64)[:, :2]
    out = np.zeros(len(pts), dtype=bool)
    reach = max(dist, 0.0)
    for poly in polygons:
        x0, y0, x1, y1 = poly.bounds
        # undecided points in reach of this polygon's box
        cand = np.flatnonzero(
            ~out
            & (pts[:, 0] >= x0 - reach) & (pts[:, 0] <= x1 + reach)
            & (pts[:, 1] >= y0 - reach) & (pts[:, 1] <= y1 + reach)
        )
        if dist:
            edges = [_ring_edges(r) for r in [poly.exterior] + list(poly.holes)]
            a = np.concatenate([e[0] for e in edges], axis=0)
            b = np.concatenate([e[1] for e in edges], axis=0)
        for lo in range(0, len(cand), chunk):
            idx = cand[lo: lo + chunk]
            keep = poly.contains_points(pts[idx])
            if dist > 0:
                # the distance only of the points the polygon does not hold
                rest = np.flatnonzero(~keep)
                keep[rest] = _distance_to_edges(pts[idx[rest]], a, b) <= dist
            elif dist < 0:
                held = np.flatnonzero(keep)
                keep[held] = _distance_to_edges(pts[idx[held]], a, b) >= -dist
            out[idx[keep]] = True
    return out


# -- raster-assisted polygon ops ---------------------------------------------


def rasterize_polygons(
    polygons: Sequence[Polygon],
    values: Sequence[int],
    bounds: Tuple[float, float, float, float],
    shape: Tuple[int, int],
    background: int = -1,
) -> np.ndarray:
    """Burn polygons into an (H, W) int32 grid over ``bounds``
    (x0, y0, x1, y1); row 0 is the TOP (max y).  Later polygons win.
    Vertices round half to even to pixel corners, as the JAX package's
    ``np.round`` does; holes are filled with ``background``."""
    h, w = shape
    x0, y0, x1, y1 = bounds
    sx = w / (x1 - x0)
    sy = h / (y1 - y0)
    img = np.full((h, w), background, dtype=np.int32)

    def pixels(ring):
        return np.round(
            np.stack([(ring[:, 0] - x0) * sx, (y1 - ring[:, 1]) * sy], axis=1)
        ).astype(np.int32)

    for poly, val in zip(polygons, values):
        fill_poly(img, pixels(poly.exterior), int(val))
        for hole in poly.holes:
            fill_poly(img, pixels(hole), int(background))
    return img


def polygons_from_mask(
    mask: np.ndarray,
    bounds: Tuple[float, float, float, float],
) -> List[Polygon]:
    """Extract polygons (with holes) from a boolean (H, W) mask over
    ``bounds``; inverse of :func:`rasterize_polygons`.  Rings run through
    the centres of the border pixels (``utils/contours.py``, cv2's
    ``findContours`` with ``RETR_CCOMP`` and ``CHAIN_APPROX_SIMPLE``);
    borders of fewer than 3 points are dropped."""
    h, w = mask.shape
    x0, y0, x1, y1 = bounds
    sx = (x1 - x0) / w
    sy = (y1 - y0) / h
    contours, hierarchy = find_contours(mask)
    if not contours:
        return []

    def to_world(c):
        c = c.astype(np.float64)
        return np.stack(
            [x0 + (c[:, 0] + 0.5) * sx, y1 - (c[:, 1] + 0.5) * sy], axis=1
        )

    polys = []
    for i, cont in enumerate(contours):
        if hierarchy[i][3] != -1:  # a hole; handled with its parent
            continue
        if len(cont) < 3:
            continue
        holes = []
        child = hierarchy[i][2]
        while child != -1:
            if len(contours[child]) >= 3:
                holes.append(to_world(contours[child]))
            child = hierarchy[child][0]
        polys.append(Polygon(to_world(cont), holes))
    return polys


def buffer_polygons(
    polygons: Sequence[Polygon],
    dist: float,
    resolution: int = 8,
    grid: int = 2048,
) -> List[Polygon]:
    """Raster-based polygon buffering (dilate by ``dist``; negative
    erodes): the polygons burnt into a ``grid`` x ``grid`` mask over their
    bounds padded by 1.5 ``dist``, dilated or eroded with an ellipse of
    ``2 dist`` pixels, traced back.  ``resolution`` is accepted and
    unused, as in the JAX package."""
    if not polygons:
        return []
    bs = np.asarray([p.bounds for p in polygons])
    pad = abs(dist) * 1.5 + 1e-9
    x0, y0 = bs[:, 0].min() - pad, bs[:, 1].min() - pad
    x1, y1 = bs[:, 2].max() + pad, bs[:, 3].max() + pad
    bounds = (x0, y0, x1, y1)
    mask = rasterize_polygons(
        polygons, [1] * len(polygons), bounds, (grid, grid), 0) > 0
    px = abs(dist) * grid / max(x1 - x0, y1 - y0)
    kernel = ellipse_kernel(max(int(round(px * 2)) | 1, 3))
    out = dilate(mask, kernel) if dist > 0 else erode(mask, kernel)
    return polygons_from_mask(out, bounds)


def union_all(
    polygons: Sequence[Polygon], grid: int = 4096, method: str = "auto"
) -> List[Polygon]:
    """Union of many polygons.

    ``method="exact"`` runs the planar-arrangement boolean engine
    (:mod:`utils.boolean_ops`, no grid); ``"raster"`` burns onto a
    ``grid``-sized image and re-vectorizes; ``"auto"`` (default) picks
    exact up to 10^5 edges.
    """
    if not polygons:
        return []
    n_edges = sum(int(p.exterior.shape[0]) for p in polygons) + sum(
        int(h.shape[0]) for p in polygons for h in p.holes
    )
    if method == "exact" or (method == "auto" and n_edges <= 100_000):
        from geograypher_tpu_torch.utils.boolean_ops import union_exact

        return union_exact(polygons)
    bs = np.asarray([p.bounds for p in polygons])
    x0, y0, x1, y1 = bs[:, 0].min(), bs[:, 1].min(), bs[:, 2].max(), bs[:, 3].max()
    pad = max(x1 - x0, y1 - y0) * 0.01 + 1e-9
    bounds = (x0 - pad, y0 - pad, x1 + pad, y1 + pad)
    mask = rasterize_polygons(polygons, [1] * len(polygons), bounds, (grid, grid), 0)
    return polygons_from_mask(mask > 0, bounds)
