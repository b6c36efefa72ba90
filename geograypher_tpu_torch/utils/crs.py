"""Self-contained coordinate-reference-system engine (replaces pyproj).

The port's own copy of ``geograypher_tpu/utils/crs.py`` (numpy only),
holding what :func:`transform_points`, :func:`utm_epsg_for`,
:func:`ecef_to_lla` and the SRS parser (``utils/parsing.py``) need.  The
transforms geograypher uses, in vectorized numpy (float64, host side):

* Geographic lat/lon/alt: WGS84 (EPSG:4326), NAD83 (4269), ETRS89 (4258)
* Geocentric ECEF (EPSG:4978)
* Transverse-Mercator projected families via Karney's 6th-order series
  (sub-millimeter accuracy): WGS84 UTM (326xx N / 327xx S), NAD83 UTM
  (269xx, zones 1-23 N), ETRS89 UTM (258xx, zones 28-38)
* Web Mercator / pseudo-Mercator (EPSG:3857)
* UTM zone selection from lat/lon (reference geospatial.py:51-58)

Datum note: NAD83/ETRS89 use the GRS80 ellipsoid, whose flattening differs
from WGS84's by ~1e-10 (semi-minor axes differ by 0.1 mm); the series
coefficients are shared.  Datum SHIFTS between WGS84 and NAD83/ETRS89
(~1-2 m, time-dependent) are NOT applied — the identity ("ballpark") datum
mapping matches what pyproj does without an explicit transformation
pipeline for most survey exports, and is well under the scale of the
meshes' own georeferencing error.  Unsupported EPSG codes raise ValueError
naming the supported families.

Axis conventions follow the reference's pyproj usage
(``convert_CRS_3D_points`` geospatial.py:60-72, which calls
``Transformer.from_crs`` WITHOUT always_xy): EPSG:4326 point columns are
``(lat, lon, alt)``; projected/ECEF CRSs are ``(x/easting, y/northing, z)``.
"""

from __future__ import annotations

import numpy as np

# WGS84 ellipsoid
WGS84_A = 6378137.0
WGS84_F = 1.0 / 298.257223563
WGS84_B = WGS84_A * (1.0 - WGS84_F)
WGS84_E2 = WGS84_F * (2.0 - WGS84_F)  # first eccentricity squared
WGS84_E = np.sqrt(WGS84_E2)

# Third flattening and rectifying radius for the transverse Mercator series
_N = WGS84_F / (2.0 - WGS84_F)
_A_RECT = (WGS84_A / (1.0 + _N)) * (
    1.0 + _N**2 / 4.0 + _N**4 / 64.0 + _N**6 / 256.0
)

# Karney forward (alpha) and inverse (beta) series coefficients, order 6
_ALPHA = np.array(
    [
        _N / 2 - 2 * _N**2 / 3 + 5 * _N**3 / 16 + 41 * _N**4 / 180
        - 127 * _N**5 / 288 + 7891 * _N**6 / 37800,
        13 * _N**2 / 48 - 3 * _N**3 / 5 + 557 * _N**4 / 1440
        + 281 * _N**5 / 630 - 1983433 * _N**6 / 1935360,
        61 * _N**3 / 240 - 103 * _N**4 / 140 + 15061 * _N**5 / 26880
        + 167603 * _N**6 / 181440,
        49561 * _N**4 / 161280 - 179 * _N**5 / 168 + 6601661 * _N**6 / 7257600,
        34729 * _N**5 / 80640 - 3418889 * _N**6 / 1995840,
        212378941 * _N**6 / 319334400,
    ]
)
_BETA = np.array(
    [
        _N / 2 - 2 * _N**2 / 3 + 37 * _N**3 / 96 - _N**4 / 360
        - 81 * _N**5 / 512 + 96199 * _N**6 / 604800,
        _N**2 / 48 + _N**3 / 15 - 437 * _N**4 / 1440 + 46 * _N**5 / 105
        - 1118711 * _N**6 / 3870720,
        17 * _N**3 / 480 - 37 * _N**4 / 840 - 209 * _N**5 / 4480
        + 5569 * _N**6 / 90720,
        4397 * _N**4 / 161280 - 11 * _N**5 / 504 - 830251 * _N**6 / 7257600,
        4583 * _N**5 / 161280 - 108847 * _N**6 / 3991680,
        20648693 * _N**6 / 638668800,
    ]
)

UTM_K0 = 0.9996
UTM_FALSE_EASTING = 500000.0
UTM_FALSE_NORTHING_SOUTH = 10000000.0


def lla_to_ecef(lat_deg, lon_deg, alt):
    """WGS84 geodetic -> ECEF (EPSG:4326 -> EPSG:4978). Returns (x, y, z)."""
    lat = np.deg2rad(np.asarray(lat_deg, dtype=np.float64))
    lon = np.deg2rad(np.asarray(lon_deg, dtype=np.float64))
    alt = np.asarray(alt, dtype=np.float64)
    sin_lat, cos_lat = np.sin(lat), np.cos(lat)
    n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sin_lat**2)
    x = (n + alt) * cos_lat * np.cos(lon)
    y = (n + alt) * cos_lat * np.sin(lon)
    z = (n * (1.0 - WGS84_E2) + alt) * sin_lat
    return x, y, z


def ecef_to_lla(x, y, z, iterations: int = 6):
    """ECEF -> WGS84 geodetic. Returns (lat_deg, lon_deg, alt).

    Iterative method; converges to well below 1e-9 deg / 1e-6 m for
    terrestrial points in a handful of iterations.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    z = np.asarray(z, dtype=np.float64)
    lon = np.arctan2(y, x)
    p = np.hypot(x, y)
    # Initial guess (spherical)
    lat = np.arctan2(z, p * (1.0 - WGS84_E2))
    alt = np.zeros_like(p)
    for _ in range(iterations):
        sin_lat = np.sin(lat)
        n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sin_lat**2)
        alt = p / np.cos(lat) - n
        lat = np.arctan2(z, p * (1.0 - WGS84_E2 * n / (n + alt)))
    return np.rad2deg(lat), np.rad2deg(lon), alt


def utm_epsg_for(lat, lon, assume_western_hem: bool = False) -> int:
    """UTM EPSG code containing (lat, lon).

    Mirrors the reference formula (geospatial.py:51-58).  The reference's
    ``assume_western_hem`` default is True (forest plots in the US); here it
    defaults to False and is opt-in.
    """
    lat = float(lat)
    lon = float(lon)
    if assume_western_hem and lon > 0:
        lon = -lon
    return int(32700 - round((45 + lat) / 90) * 100 + round((183 + lon) / 6))


# Geographic (lat, lon, alt) codes sharing the identity datum mapping
GEOGRAPHIC_EPSG = frozenset({4326, 4269, 4258})
WEB_MERCATOR_EPSG = 3857
_SUPPORTED_FAMILIES = (
    "4326/4269/4258 (geographic lat/lon), 4978 (ECEF), 3857 (Web Mercator), "
    "326xx/327xx (WGS84 UTM), 269xx (NAD83 UTM), 258xx (ETRS89 UTM)"
)


def _utm_zone_params(epsg: int):
    """(lon0_rad, false_northing) for any supported UTM family code."""
    epsg = int(epsg)
    if 32601 <= epsg <= 32660:  # WGS84 north
        zone, north = epsg - 32600, True
    elif 32701 <= epsg <= 32760:  # WGS84 south
        zone, north = epsg - 32700, False
    elif 26901 <= epsg <= 26923:  # NAD83 north (GRS80; shared series)
        zone, north = epsg - 26900, True
    elif 25828 <= epsg <= 25838:  # ETRS89 north (GRS80; shared series)
        zone, north = epsg - 25800, True
    else:
        raise ValueError(
            f"EPSG:{epsg} is not a supported projected code; supported "
            f"families: {_SUPPORTED_FAMILIES}"
        )
    lon0 = np.deg2rad(zone * 6.0 - 183.0)
    return lon0, (0.0 if north else UTM_FALSE_NORTHING_SOUTH)


def _is_utm(epsg: int) -> bool:
    try:
        _utm_zone_params(epsg)
        return True
    except ValueError:
        return False


def web_mercator_from_lla(lat_deg, lon_deg):
    """WGS84 geodetic -> EPSG:3857 (spherical pseudo-Mercator; geodetic
    latitude used directly, per the 3857 definition)."""
    lat = np.deg2rad(np.asarray(lat_deg, dtype=np.float64))
    lon = np.deg2rad(np.asarray(lon_deg, dtype=np.float64))
    x = WGS84_A * lon
    y = WGS84_A * np.log(np.tan(np.pi / 4.0 + lat / 2.0))
    return x, y


def lla_from_web_mercator(x, y):
    """EPSG:3857 -> WGS84 geodetic (lat_deg, lon_deg)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    lon = np.rad2deg(x / WGS84_A)
    lat = np.rad2deg(2.0 * np.arctan(np.exp(y / WGS84_A)) - np.pi / 2.0)
    return lat, lon


def lla_to_tm(lat_deg, lon_deg, lon0_rad, k0, false_e, false_n):
    """Geodetic -> transverse Mercator easting/northing (Karney series)."""
    lat = np.deg2rad(np.asarray(lat_deg, dtype=np.float64))
    lon = np.deg2rad(np.asarray(lon_deg, dtype=np.float64)) - lon0_rad
    # wrap to [-pi, pi]
    lon = np.arctan2(np.sin(lon), np.cos(lon))
    sin_lat = np.sin(lat)
    # Conformal latitude
    t = np.sinh(
        np.arctanh(sin_lat) - WGS84_E * np.arctanh(WGS84_E * sin_lat)
    )
    xi_p = np.arctan2(t, np.cos(lon))
    eta_p = np.arcsinh(np.sin(lon) / np.hypot(t, np.cos(lon)))
    xi = xi_p.copy()
    eta = eta_p.copy()
    for j in range(6):
        m = 2.0 * (j + 1)
        xi += _ALPHA[j] * np.sin(m * xi_p) * np.cosh(m * eta_p)
        eta += _ALPHA[j] * np.cos(m * xi_p) * np.sinh(m * eta_p)
    easting = false_e + k0 * _A_RECT * eta
    northing = false_n + k0 * _A_RECT * xi
    return easting, northing


def tm_to_lla(easting, northing, lon0_rad, k0, false_e, false_n):
    """Transverse Mercator -> geodetic (lat_deg, lon_deg)."""
    xi = (np.asarray(northing, dtype=np.float64) - false_n) / (k0 * _A_RECT)
    eta = (np.asarray(easting, dtype=np.float64) - false_e) / (k0 * _A_RECT)
    xi_p = xi.copy()
    eta_p = eta.copy()
    for j in range(6):
        m = 2.0 * (j + 1)
        xi_p -= _BETA[j] * np.sin(m * xi) * np.cosh(m * eta)
        eta_p -= _BETA[j] * np.cos(m * xi) * np.sinh(m * eta)
    sinh_eta = np.sinh(eta_p)
    cos_xi = np.cos(xi_p)
    lon = np.arctan2(sinh_eta, cos_xi)
    tau_p = np.sin(xi_p) / np.hypot(sinh_eta, cos_xi)
    # Invert the conformal latitude with Newton's method (Karney 2011 eq. 19-21)
    tau = tau_p / (1.0 - WGS84_E2)
    for _ in range(5):
        sqrt1t = np.sqrt(1.0 + tau**2)
        sigma = np.sinh(WGS84_E * np.arctanh(WGS84_E * tau / sqrt1t))
        f_tau = tau * np.sqrt(1.0 + sigma**2) - sigma * sqrt1t - tau_p
        d_tau = (
            (np.sqrt((1.0 + sigma**2) * (1.0 + tau**2)) - sigma * tau)
            * (1.0 - WGS84_E2)
            * sqrt1t
            / (1.0 + (1.0 - WGS84_E2) * tau**2)
        )
        tau = tau - f_tau / d_tau
    lat = np.arctan(tau)
    return np.rad2deg(lat), np.rad2deg(lon) + np.rad2deg(lon0_rad)


# ---------------------------------------------------------------------------
# Conic projections (Lambert Conformal Conic, Albers Equal Area) + registry
#
# Unlocks US state-plane zones (most are LCC or TM), CONUS Albers grids
# (EPSG:5070/6350), and ARBITRARY WKT-described projected CRSs via
# utils.parsing.projdef_from_wkt -> register_projected_crs.  The reference
# gets all of this from pyproj (geospatial.py:60-72); formulas follow
# Snyder, "Map Projections — A Working Manual" (USGS PP 1395).
# ---------------------------------------------------------------------------

GRS80_F = 1.0 / 298.257222101
GRS80_E2 = GRS80_F * (2.0 - GRS80_F)

_DATUM_E2 = {"WGS84": WGS84_E2, "NAD83": GRS80_E2, "ETRS89": GRS80_E2}


def _ellipsoid(datum: str):
    """(a, e2) for a named datum's ellipsoid (a is shared)."""
    return WGS84_A, _DATUM_E2.get(str(datum).upper(), WGS84_E2)


def make_projdef(
    kind: str,
    lat0: float = 0.0,
    lon0: float = 0.0,
    sp1: float = None,
    sp2: float = None,
    k0: float = 1.0,
    fe: float = 0.0,
    fn: float = 0.0,
    unit: float = 1.0,
    datum: str = "WGS84",
) -> dict:
    """Projection definition: ``kind`` in {"lcc2sp", "lcc1sp", "tm", "aea"};
    angles in degrees, false easting/northing in METERS, ``unit`` = meters
    per native coordinate unit (e.g. 0.3048006096012192 for US survey ft).
    """
    return {
        "kind": kind, "lat0": float(lat0), "lon0": float(lon0),
        "sp1": lat0 if sp1 is None else float(sp1),
        "sp2": sp2 if sp2 is None else float(sp2),
        "k0": float(k0), "fe": float(fe), "fn": float(fn),
        "unit": float(unit), "datum": str(datum).upper(),
    }


def _m_snyder(lat, e2):
    s = np.sin(lat)
    return np.cos(lat) / np.sqrt(1.0 - e2 * s * s)


def _t_snyder(lat, e):
    s = np.sin(lat)
    return np.tan(np.pi / 4.0 - lat / 2.0) / (
        (1.0 - e * s) / (1.0 + e * s)
    ) ** (e / 2.0)


def _lcc_constants(p):
    a, e2 = _ellipsoid(p["datum"])
    e = np.sqrt(e2)
    lat0 = np.deg2rad(p["lat0"])
    sp1 = np.deg2rad(p["sp1"])
    if p["kind"] == "lcc1sp" or p["sp2"] is None or p["sp2"] == p["sp1"]:
        n = np.sin(sp1)
    else:
        sp2 = np.deg2rad(p["sp2"])
        n = (np.log(_m_snyder(sp1, e2)) - np.log(_m_snyder(sp2, e2))) / (
            np.log(_t_snyder(sp1, e)) - np.log(_t_snyder(sp2, e))
        )
    F = _m_snyder(sp1, e2) / (n * _t_snyder(sp1, e) ** n)
    rho0 = a * p["k0"] * F * _t_snyder(lat0, e) ** n
    return a, e2, e, n, F, rho0


def lcc_forward(p: dict, lat_deg, lon_deg):
    """Geodetic -> Lambert Conformal Conic easting/northing (meters)."""
    a, e2, e, n, F, rho0 = _lcc_constants(p)
    lat = np.deg2rad(np.asarray(lat_deg, np.float64))
    dlon = np.deg2rad(np.asarray(lon_deg, np.float64) - p["lon0"])
    dlon = np.arctan2(np.sin(dlon), np.cos(dlon))
    rho = a * p["k0"] * F * _t_snyder(lat, e) ** n
    theta = n * dlon
    return p["fe"] + rho * np.sin(theta), p["fn"] + rho0 - rho * np.cos(theta)


def lcc_inverse(p: dict, easting, northing):
    """Lambert Conformal Conic easting/northing (meters) -> geodetic."""
    a, e2, e, n, F, rho0 = _lcc_constants(p)
    x = np.asarray(easting, np.float64) - p["fe"]
    y = rho0 - (np.asarray(northing, np.float64) - p["fn"])
    rho = np.sign(n) * np.hypot(x, y)
    theta = np.arctan2(np.sign(n) * x, np.sign(n) * y)
    t = (rho / (a * p["k0"] * F)) ** (1.0 / n)
    lat = np.pi / 2.0 - 2.0 * np.arctan(t)
    for _ in range(8):
        s = np.sin(lat)
        lat = np.pi / 2.0 - 2.0 * np.arctan(
            t * ((1.0 - e * s) / (1.0 + e * s)) ** (e / 2.0)
        )
    lon = np.rad2deg(theta / n) + p["lon0"]
    return np.rad2deg(lat), lon


def _q_snyder(lat, e, e2):
    s = np.sin(lat)
    return (1.0 - e2) * (
        s / (1.0 - e2 * s * s)
        - (1.0 / (2.0 * e)) * np.log((1.0 - e * s) / (1.0 + e * s))
    )


def _aea_constants(p):
    a, e2 = _ellipsoid(p["datum"])
    e = np.sqrt(e2)
    lat0 = np.deg2rad(p["lat0"])
    sp1 = np.deg2rad(p["sp1"])
    sp2 = np.deg2rad(p["sp2"] if p["sp2"] is not None else p["sp1"])
    m1 = _m_snyder(sp1, e2)
    q0, q1, q2 = (
        _q_snyder(x, e, e2) for x in (lat0, sp1, sp2)
    )
    if abs(sp1 - sp2) < 1e-12:
        n = np.sin(sp1)
    else:
        m2 = _m_snyder(sp2, e2)
        n = (m1 * m1 - m2 * m2) / (q2 - q1)
    C = m1 * m1 + n * q1
    rho0 = a * np.sqrt(C - n * q0) / n
    return a, e2, e, n, C, rho0


def aea_forward(p: dict, lat_deg, lon_deg):
    """Geodetic -> Albers Equal Area easting/northing (meters)."""
    a, e2, e, n, C, rho0 = _aea_constants(p)
    lat = np.deg2rad(np.asarray(lat_deg, np.float64))
    dlon = np.deg2rad(np.asarray(lon_deg, np.float64) - p["lon0"])
    dlon = np.arctan2(np.sin(dlon), np.cos(dlon))
    q = _q_snyder(lat, e, e2)
    rho = a * np.sqrt(C - n * q) / n
    theta = n * dlon
    return p["fe"] + rho * np.sin(theta), p["fn"] + rho0 - rho * np.cos(theta)


def aea_inverse(p: dict, easting, northing):
    """Albers Equal Area easting/northing (meters) -> geodetic."""
    a, e2, e, n, C, rho0 = _aea_constants(p)
    x = np.asarray(easting, np.float64) - p["fe"]
    y = rho0 - (np.asarray(northing, np.float64) - p["fn"])
    rho = np.hypot(x, y)
    theta = np.arctan2(np.sign(n) * x, np.sign(n) * y)
    q = (C - (rho * n / a) ** 2) / n
    lat = np.arcsin(np.clip(q / 2.0, -1.0, 1.0))
    for _ in range(8):
        s = np.sin(lat)
        lat = lat + (1.0 - e2 * s * s) ** 2 / (2.0 * np.cos(lat)) * (
            q / (1.0 - e2)
            - s / (1.0 - e2 * s * s)
            + (1.0 / (2.0 * e)) * np.log((1.0 - e * s) / (1.0 + e * s))
        )
    return np.rad2deg(lat), np.rad2deg(theta / n) + p["lon0"]


# Known projected EPSG codes beyond the UTM families.  Parameters are the
# published zone definitions (meters); WKT-described CRSs with other codes
# go through register_projected_crs instead.
_EPSG_PROJ_TABLE = {
    # CONUS Albers Equal Area (NAD83 / NAD83(2011))
    5070: make_projdef("aea", lat0=23.0, lon0=-96.0, sp1=29.5, sp2=45.5,
                       datum="NAD83"),
    6350: make_projdef("aea", lat0=23.0, lon0=-96.0, sp1=29.5, sp2=45.5,
                       datum="NAD83"),
    # California State Plane NAD83, zones 1-6 (LCC 2SP, meters)
    26941: make_projdef("lcc2sp", lat0=39.0 + 1 / 3, lon0=-122.0,
                        sp1=40.0, sp2=41.0 + 2 / 3,
                        fe=2000000.0, fn=500000.0, datum="NAD83"),
    26942: make_projdef("lcc2sp", lat0=37.0 + 2 / 3, lon0=-122.0,
                        sp1=38.0 + 1 / 3, sp2=39.0 + 5 / 6,
                        fe=2000000.0, fn=500000.0, datum="NAD83"),
    26943: make_projdef("lcc2sp", lat0=36.5, lon0=-120.5,
                        sp1=37.0 + 1 / 15, sp2=38.0 + 26 / 60,
                        fe=2000000.0, fn=500000.0, datum="NAD83"),
    26944: make_projdef("lcc2sp", lat0=35.0 + 1 / 3, lon0=-119.0,
                        sp1=36.0, sp2=37.25,
                        fe=2000000.0, fn=500000.0, datum="NAD83"),
    26945: make_projdef("lcc2sp", lat0=33.5, lon0=-118.0,
                        sp1=34.0 + 2 / 60, sp2=35.0 + 28 / 60,
                        fe=2000000.0, fn=500000.0, datum="NAD83"),
    26946: make_projdef("lcc2sp", lat0=32.0 + 1 / 6, lon0=-116.25,
                        sp1=32.0 + 47 / 60, sp2=33.0 + 53 / 60,
                        fe=2000000.0, fn=500000.0, datum="NAD83"),
}

# custom (WKT-described) projected CRSs get synthetic codes from here up
_CUSTOM_CRS_BASE = 900001
_custom_crs: dict = {}


def register_projected_crs(projdef: dict) -> int:
    """Register a projection definition (see :func:`make_projdef`) and
    return a synthetic CRS code usable anywhere an EPSG int is accepted.
    Re-registering an identical definition returns the same code."""
    for code, p in _custom_crs.items():
        if p == projdef:
            return code
    code = _CUSTOM_CRS_BASE + len(_custom_crs)
    _custom_crs[code] = dict(projdef)
    return code


def _proj_def(epsg: int):
    epsg = int(epsg)
    if epsg in _custom_crs:
        return _custom_crs[epsg]
    return _EPSG_PROJ_TABLE.get(epsg)


def _projdef_forward(p: dict, lat, lon):
    kind = p["kind"]
    if kind in ("lcc2sp", "lcc1sp"):
        e, n = lcc_forward(p, lat, lon)
    elif kind == "aea":
        e, n = aea_forward(p, lat, lon)
    elif kind == "tm":
        e, n = lla_to_tm(
            lat, lon, np.deg2rad(p["lon0"]), p["k0"], 0.0, 0.0
        )
        # Karney series is referenced to the equator; shift to lat0 and
        # apply the false origin afterwards
        if p["lat0"] != 0.0:
            _, n0 = lla_to_tm(
                p["lat0"], p["lon0"], np.deg2rad(p["lon0"]), p["k0"], 0.0, 0.0
            )
            n = n - n0
        e, n = e + p["fe"], n + p["fn"]
    else:
        raise ValueError(f"unsupported projection kind {kind!r}")
    return e / p["unit"], n / p["unit"]


def _projdef_inverse(p: dict, easting, northing):
    easting = np.asarray(easting, np.float64) * p["unit"]
    northing = np.asarray(northing, np.float64) * p["unit"]
    kind = p["kind"]
    if kind in ("lcc2sp", "lcc1sp"):
        return lcc_inverse(p, easting, northing)
    if kind == "aea":
        return aea_inverse(p, easting, northing)
    if kind == "tm":
        n0 = 0.0
        if p["lat0"] != 0.0:
            _, n0 = lla_to_tm(
                p["lat0"], p["lon0"], np.deg2rad(p["lon0"]), p["k0"], 0.0, 0.0
            )
        return tm_to_lla(
            easting - p["fe"], northing - p["fn"] + n0,
            np.deg2rad(p["lon0"]), p["k0"], 0.0, 0.0,
        )
    raise ValueError(f"unsupported projection kind {kind!r}")


# ---------------------------------------------------------------------------
# NAD83 <-> WGS84 datum shift (opt-in)
# ---------------------------------------------------------------------------

# Time-independent Helmert evaluated at epoch 2010.0 from the published
# ITRF2008 -> NAD83(2011) transformation (EPSG:1515 / NGS HTDP):
# translations in meters, rotations in arc-seconds, scale in ppm.
# WGS84 (G1762) is coincident with ITRF2008 at the few-cm level, so this
# captures the ~1.2-1.5 m CONUS datum offset to better than a decimeter.
_NAD83_T = np.array([0.99343, -1.90331, -0.52655])
_NAD83_R_ARCSEC = np.array([0.02591467, 0.00942645, 0.01159935])
_NAD83_S_PPM = 0.00171504


def helmert_nad83_from_wgs84(xyz: np.ndarray, inverse: bool = False):
    """Apply the WGS84->NAD83(2011) 7-parameter Helmert to ECEF points.

    OPT-IN (``transform_points(..., datum_shift=True)``): survey exports
    overwhelmingly treat NAD83 and WGS84 as coincident (the reference's
    pyproj does the same without an explicit pipeline), and the offset
    (~1.4 m in CONUS) is below typical photogrammetric georeferencing
    error.  Rotations use the COORDINATE-FRAME convention NGS publishes
    these parameters in (the position-vector reading yields a ~3 m shift,
    double the documented CONUS offset).
    """
    xyz = np.asarray(xyz, np.float64)
    r = np.deg2rad(_NAD83_R_ARCSEC / 3600.0)
    s = 1.0 + _NAD83_S_PPM * 1e-6
    rot = np.array(
        [
            [1.0, r[2], -r[1]],
            [-r[2], 1.0, r[0]],
            [r[1], -r[0], 1.0],
        ]
    )
    if inverse:
        return (xyz - _NAD83_T) @ np.linalg.inv(s * rot).T
    return s * (xyz @ rot.T) + _NAD83_T


def crs_is_projected(epsg: int) -> bool:
    """True for supported projected codes, False for geographic/geocentric;
    ValueError (naming the supported families) otherwise — matching how
    reference code relies on pyproj's CRS.is_projected."""
    epsg = int(epsg)
    if epsg in GEOGRAPHIC_EPSG or epsg == 4978:
        return False
    if epsg == WEB_MERCATOR_EPSG or _is_utm(epsg) or _proj_def(epsg):
        return True
    raise ValueError(
        f"EPSG:{epsg} is not supported; supported families: "
        f"{_SUPPORTED_FAMILIES}, conic table/WKT-registered codes"
    )


def crs_is_geocentric(epsg: int) -> bool:
    """True for EPSG:4978 (ECEF), the one geocentric code supported."""
    return int(epsg) == 4978


def _datum_of(epsg: int) -> str:
    """Datum family of a supported CRS code (for opt-in datum shifts)."""
    epsg = int(epsg)
    p = _proj_def(epsg)
    if p is not None:
        return p["datum"]
    if epsg == 4269 or 26901 <= epsg <= 26923:
        return "NAD83"
    if epsg == 4258 or 25828 <= epsg <= 25838:
        return "ETRS89"
    return "WGS84"


def transform_points(
    points: np.ndarray,
    input_epsg: int,
    output_epsg: int,
    datum_shift: bool = False,
):
    """Transform an (N, 3) point array between supported CRSs.

    Column convention matches the reference's ``convert_CRS_3D_points``
    (geospatial.py:60-72): EPSG:4326 columns are (lat, lon, alt); ECEF and
    UTM are (x, y, z)/(easting, northing, alt).

    ``datum_shift=True`` applies the published WGS84<->NAD83(2011) Helmert
    when the endpoints' datums differ (see
    :func:`helmert_nad83_from_wgs84`); the default keeps the identity
    ("ballpark") datum mapping the reference's pyproj usage implies.
    """
    points = np.asarray(points, dtype=np.float64)
    squeeze = points.ndim == 1
    if squeeze:
        points = points[None]
    input_epsg = int(input_epsg)
    output_epsg = int(output_epsg)
    if input_epsg == output_epsg:
        out = points.copy()
        return out[0] if squeeze else out

    # Stage 1: to geodetic (lat, lon, alt)
    pdef = _proj_def(input_epsg)
    if pdef is not None:
        lat, lon = _projdef_inverse(pdef, points[:, 0], points[:, 1])
        alt = points[:, 2]
    elif input_epsg in GEOGRAPHIC_EPSG:
        lat, lon, alt = points[:, 0], points[:, 1], points[:, 2]
    elif input_epsg == 4978:
        lat, lon, alt = ecef_to_lla(points[:, 0], points[:, 1], points[:, 2])
    elif input_epsg == WEB_MERCATOR_EPSG:
        lat, lon = lla_from_web_mercator(points[:, 0], points[:, 1])
        alt = points[:, 2]
    else:
        lon0, fn = _utm_zone_params(input_epsg)
        lat, lon = tm_to_lla(
            points[:, 0], points[:, 1], lon0, UTM_K0, UTM_FALSE_EASTING, fn
        )
        alt = points[:, 2]

    if datum_shift:
        d_in, d_out = _datum_of(input_epsg), _datum_of(output_epsg)
        if (d_in == "NAD83") != (d_out == "NAD83"):
            xyz = np.stack(lla_to_ecef(lat, lon, alt), axis=1)
            xyz = helmert_nad83_from_wgs84(xyz, inverse=d_in == "NAD83")
            lat, lon, alt = ecef_to_lla(xyz[:, 0], xyz[:, 1], xyz[:, 2])

    # Stage 2: from geodetic to target
    pdef = _proj_def(output_epsg)
    if pdef is not None:
        e, n = _projdef_forward(pdef, lat, lon)
        out = np.stack([e, n, alt], axis=1)
    elif output_epsg in GEOGRAPHIC_EPSG:
        out = np.stack([lat, lon, alt], axis=1)
    elif output_epsg == 4978:
        x, y, z = lla_to_ecef(lat, lon, alt)
        out = np.stack([x, y, z], axis=1)
    elif output_epsg == WEB_MERCATOR_EPSG:
        x, y = web_mercator_from_lla(lat, lon)
        out = np.stack([x, y, alt], axis=1)
    else:
        lon0, fn = _utm_zone_params(output_epsg)
        e, n = lla_to_tm(lat, lon, lon0, UTM_K0, UTM_FALSE_EASTING, fn)
        out = np.stack([e, n, alt], axis=1)
    return out[0] if squeeze else out


def convert_CRS_3D_points(points, input_CRS, output_CRS):
    """:func:`transform_points` under the name the JAX package gives it."""
    return transform_points(points, input_CRS, output_CRS)
