"""Metashape export parsing helpers.

The port's own copy of ``geograypher_tpu/utils/parsing.py`` (pure XML /
string parsing, no compute).  pyproj CRS objects are replaced by EPSG ints /
WKT strings handled by :mod:`geograypher_tpu_torch.utils.crs`.
"""

from __future__ import annotations

import re
import typing
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np


def parse_metashape_mesh_metadata(
    mesh_metadata_file: typing.Union[str, Path],
) -> typing.Tuple[typing.Optional[str], typing.Optional[np.ndarray]]:
    """Parse the CRS + origin shift from a Metashape mesh-metadata XML
    (reference parsing.py:10-42).

    Returns (crs, shift): ``crs`` is the raw SRS text (WKT or
    "EPSG::<code>" style), ``shift`` an (3,) array or None.
    """
    tree = ET.parse(mesh_metadata_file)
    root = tree.getroot()
    crs_el = root.find("SRS")
    shift_el = root.find("SRSOrigin")
    crs = crs_el.text if crs_el is not None else None
    shift = (
        np.array(shift_el.text.split(","), dtype=float)
        if shift_el is not None
        else None
    )
    return crs, shift


def extract_epsg(crs_text: typing.Optional[str]) -> typing.Optional[int]:
    """Best-effort EPSG code extraction from an SRS string (WKT AUTHORITY
    tail or 'EPSG::NNNN' syntax)."""
    if crs_text is None:
        return None
    m = re.search(r"EPSG[\":,]+(\d+)", crs_text)
    if m:
        codes = re.findall(r'AUTHORITY\["EPSG",\s*"?(\d+)"?\]', crs_text)
        if codes:
            # the outermost CRS's authority is the LAST code in its own
            # block, but a compound WKT (horizontal + VERT_CS) ends with
            # the vertical datum's code — walk right-to-left and return
            # the first code the CRS engine accepts as horizontal
            from geograypher_tpu_torch.utils import crs as crs_utils

            for code in reversed(codes):
                try:
                    crs_utils.crs_is_projected(int(code))
                    return int(code)
                except ValueError:
                    continue
            return int(codes[-1])
        return int(m.group(1))
    return None


_WKT_PROJ_KINDS = {
    "lambertconformalconic2sp": "lcc2sp",
    "lambertconformalconic": "lcc2sp",
    "lambertconformalconic1sp": "lcc1sp",
    "transversemercator": "tm",
    "albersconicequalarea": "aea",
    "albers": "aea",
    "albersequalarea": "aea",
}

_WKT_PARAM_MAP = {
    "latitudeoforigin": "lat0",
    "latitudeofcenter": "lat0",
    "centralmeridian": "lon0",
    "longitudeofcenter": "lon0",
    "standardparallel1": "sp1",
    "standardparallel2": "sp2",
    "scalefactor": "k0",
    "falseeasting": "fe",
    "falsenorthing": "fn",
}


def _wkt_key(name: str) -> str:
    return re.sub(r"[^a-z0-9]", "", name.lower())


def projdef_from_wkt(wkt: str) -> typing.Optional[dict]:
    """Parse a WKT1 ``PROJCS`` into a :func:`geograypher_tpu_torch.utils.crs
    .make_projdef` dict (Lambert Conformal Conic / Transverse Mercator /
    Albers), or None when the string is not a parseable PROJCS.

    Covers state-plane and national-grid exports (ESRI .prj, GeoTIFF WKT)
    that carry no usable ``AUTHORITY`` code — the reference feeds such
    strings straight to pyproj (geospatial.py:60-72).  False origins are
    converted to meters via the PROJCS linear UNIT (US survey foot etc.).
    """
    if not wkt or "PROJCS" not in wkt:
        return None
    m = re.search(r'PROJECTION\["([^"]+)"', wkt)
    if not m:
        return None
    kind = _WKT_PROJ_KINDS.get(_wkt_key(m.group(1)))
    if kind is None:
        return None
    params = {}
    for name, value in re.findall(
        r'PARAMETER\["([^"]+)"\s*,\s*([-+0-9.eE]+)', wkt
    ):
        key = _WKT_PARAM_MAP.get(_wkt_key(name))
        if key:
            params[key] = float(value)
    # linear unit: the last UNIT in the PROJCS (the first, inside GEOGCS,
    # is angular).  Factor = meters per unit.
    units = re.findall(r'UNIT\["([^"]+)"\s*,\s*([-+0-9.eE]+)', wkt)
    unit = float(units[-1][1]) if units else 1.0
    if unit < 0.01:  # angular factor (radian-per-degree): no linear unit
        unit = 1.0
    upper = wkt.upper()
    if "NAD" in upper and "83" in upper:
        datum = "NAD83"
    elif "ETRS" in upper:
        datum = "ETRS89"
    else:
        datum = "WGS84"
    if kind == "lcc2sp" and "sp2" not in params and "k0" in params:
        kind = "lcc1sp"
    from geograypher_tpu_torch.utils.crs import make_projdef

    return make_projdef(
        kind,
        lat0=params.get("lat0", 0.0),
        lon0=params.get("lon0", 0.0),
        sp1=params.get("sp1", params.get("lat0", 0.0)),
        sp2=params.get("sp2"),
        k0=params.get("k0", 1.0),
        fe=params.get("fe", 0.0) * unit,
        fn=params.get("fn", 0.0) * unit,
        unit=unit,
        datum=datum,
    )


def crs_from_srs_text(crs_text: typing.Optional[str]) -> typing.Optional[int]:
    """SRS text (WKT or EPSG syntax) -> a CRS code the crs engine accepts.

    Resolution order: a supported AUTHORITY/EPSG code; else the PROJCS
    parameters themselves (registered as a synthetic code); else None with
    a LOUD warning — silently treating georeferenced data as local-frame
    is how surveys get mislocated.
    """
    import logging

    from geograypher_tpu_torch.utils import crs as crs_utils

    if crs_text is None:
        return None
    epsg = extract_epsg(crs_text)
    if epsg is not None:
        try:
            crs_utils.crs_is_projected(epsg)
            return epsg
        except ValueError:
            pass  # unsupported code: try the WKT parameters directly
    projdef = projdef_from_wkt(crs_text)
    if projdef is not None:
        return crs_utils.register_projected_crs(projdef)
    logging.getLogger(__name__).warning(
        "SRS text present but not parseable as EPSG or PROJCS WKT — "
        "data will be treated as LOCAL-FRAME (unreferenced): %.120s",
        crs_text,
    )
    return None


def assemble_transform(
    rotation: np.ndarray, translation: np.ndarray, scale: float = 1.0
) -> np.ndarray:
    """Homogeneous 4x4 from a rotation, translation and uniform scale.

    The rotation must be special-orthogonal (|det - 1| <= 1e-8); scale is
    folded into the linear block.  Behavior matches the transform the
    reference builds from Metashape XML (parsing.py:44-69), expressed over
    arrays rather than strings.
    """
    linear = np.asarray(rotation, dtype=np.float64).reshape(3, 3)
    det = float(np.linalg.det(linear))
    if abs(det - 1.0) > 1e-8:
        raise ValueError(
            f"rotation block is not special-orthogonal (det={det!r})"
        )
    out = np.zeros((4, 4), dtype=np.float64)
    out[:3, :3] = linear * float(scale)
    out[:3, 3] = np.asarray(translation, dtype=np.float64).reshape(3)
    out[3, 3] = 1.0
    return out


def make_4x4_transform(
    rotation_str: str, translation_str: str, scale_str: str = "1"
) -> np.ndarray:
    """String-triplet adapter for Metashape XML fields (row-major rotation,
    translation, uniform scale) -> :func:`assemble_transform`."""
    return assemble_transform(
        np.fromstring(rotation_str, sep=" "),
        np.fromstring(translation_str, sep=" "),
        float(scale_str),
    )


def parse_transform_metashape(camera_file) -> typing.Optional[np.ndarray]:
    """Chunk->ECEF 4x4 from a Metashape camera XML (reference parsing.py:71-89)."""
    tree = ET.parse(camera_file)
    root = tree.getroot()
    components = root.find("chunk").find("components")
    if components is None:
        return None
    assert len(components) == 1
    transform = components.find("component").find("transform")
    if transform is None:
        return None
    rotation = transform.find("rotation").text
    translation = transform.find("translation").text
    scale = transform.find("scale").text
    return make_4x4_transform(rotation, translation, scale)


_NON_DISTORTION_TAGS = frozenset({"resolution", "f", "cx", "cy"})


def _parse_one_sensor(
    sensor, defaults: typing.Optional[dict]
) -> typing.Optional[dict]:
    """Intrinsics dict for a single <sensor> element, or None if the sensor
    is unusable (no adjusted calibration and no defaults to fall back on).
    """
    resolution = sensor[0]
    size = {
        "image_width": int(resolution.get("width")),
        "image_height": int(resolution.get("height")),
    }

    calibration = sensor.find("calibration[@class='adjusted']")
    if calibration is None:
        # Unadjusted sensor: usable only when caller-supplied defaults
        # stand in for the missing calibration.
        return {**size, **defaults} if defaults is not None else None

    params: typing.Dict[str, typing.Any] = {
        **size,
        "f": float(calibration.find("f").text),
        "distortion_params": {
            el.tag: float(el.text)
            for el in calibration
            if el.tag not in _NON_DISTORTION_TAGS
        },
    }
    # Principal point offsets may be omitted from the XML; fall back to the
    # defaults, and reject the sensor if neither source provides them.
    for key in ("cx", "cy"):
        el = calibration.find(key)
        if el is not None:
            params[key] = float(el.text)
        elif defaults is not None and key in defaults:
            params[key] = defaults[key]
        else:
            return None
    return params


def parse_sensors(
    sensors, default_sensor_dict: typing.Optional[dict] = None
) -> typing.Dict[int, typing.Optional[dict]]:
    """Per-sensor-id intrinsics dicts from a Metashape <sensors> element.

    Same accept/reject semantics as the reference parser
    (parsing.py:91-134): sensors that cannot be calibrated map to None and
    their cameras are dropped downstream.
    """
    return {
        int(sensor.get("id")): _parse_one_sensor(sensor, default_sensor_dict)
        for sensor in sensors
    }
