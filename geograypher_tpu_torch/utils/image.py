"""Image-space utilities: EXIF GPS, camera-frame rotations, equirectangular
-> perspective resampling (numpy, on the host).

Port of ``geograypher_tpu/utils/image.py`` without PIL or cv2:

* :func:`get_GPS_exif` reads the EXIF TIFF directory (a JPEG's APP1
  ``Exif\\0\\0`` segment, a PNG's ``eXIf`` chunk, or a TIFF file itself)
  with ``utils/tiff.py``'s directory reader, follows IFD0's GPS pointer
  (tag 0x8825) and reads the degree / minute / second rationals and their
  N/S/E/W references; the JPEG is not decoded.  It returns ``None``
  where the JAX version (PIL) does: an unreadable file, no GPS directory,
  a missing tag.
* :func:`perspective_from_equirectangular` samples with the host
  bilinear remap of ``cameras/distortion.py`` (longitude wrapped, latitude
  clamped) where the JAX version calls ``cv2.remap`` (``INTER_LINEAR``,
  ``BORDER_WRAP``), and area-downsamples an oversampled view with
  ``utils/io.py`` ``resize_area`` (cv2's ``INTER_AREA``).  cv2 rounds
  the sampling position to 1/32 px and, on uint8, weighs in fixed point,
  while the port interpolates in float32 at the exact position: uint8
  views differ by a level or so, float32 views by the change of the image
  over 1/64 px.  The sampled mask rounds the same maps and is equal.
"""

from __future__ import annotations

import struct
import typing

import numpy as np

from geograypher_tpu_torch.constants import PATH_TYPE
from geograypher_tpu_torch.utils.numeric import rotation_rpy_to_matrix

EXIF_GPS_IFD = 0x8825
GPS_LATITUDE_REF, GPS_LATITUDE, GPS_LONGITUDE_REF, GPS_LONGITUDE = 1, 2, 3, 4
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _exif_tiff(data: bytes) -> typing.Optional[bytes]:
    """The EXIF TIFF structure of a JPEG, PNG or TIFF file's bytes, or
    None where the file carries none."""
    if data[:2] in (b"II", b"MM"):
        return data
    if data[:8] == _PNG_SIGNATURE:
        at = 8
        while at + 8 <= len(data):
            length, kind = struct.unpack_from(">I4s", data, at)
            if kind == b"eXIf":
                return data[at + 8:at + 8 + length]
            if kind == b"IEND":
                return None
            at += 12 + length
        return None
    if data[:2] != b"\xff\xd8":
        return None
    at = 2
    while at + 4 <= len(data) and data[at] == 0xFF:
        marker = data[at + 1]
        if marker == 0xFF:  # fill byte
            at += 1
            continue
        if marker in (0x01, *range(0xD0, 0xD8)):  # no length
            at += 2
            continue
        if marker in (0xD9, 0xDA):  # end of image, start of scan
            return None
        (length,) = struct.unpack_from(">H", data, at + 2)
        payload = data[at + 4:at + 2 + length]
        if marker == 0xE1 and payload[:6] == b"Exif\x00\x00":
            return payload[6:]
        at += 2 + length
    return None


def get_GPS_exif(image_filename: PATH_TYPE) -> typing.Optional[tuple]:
    """(lon, lat) in degrees from the file's EXIF GPS tags, or None."""
    from geograypher_tpu_torch.utils.tiff import _layout, _read_ifd

    try:
        with open(image_filename, "rb") as fh:
            tiff = _exif_tiff(fh.read())
        if tiff is None:
            return None
        lay, first = _layout(tiff, image_filename)
        pointer = _read_ifd(tiff, lay, first).get(EXIF_GPS_IFD)
        if not pointer:
            return None
        gps = _read_ifd(tiff, lay, int(pointer[0]))
    except (OSError, ValueError, struct.error, TypeError):
        return None
    if not gps:
        return None

    def dms_to_deg(dms, ref):
        deg = float(dms[0]) + float(dms[1]) / 60 + float(dms[2]) / 3600
        return -deg if ref in ("S", "W") else deg

    try:
        lat = dms_to_deg(gps[GPS_LATITUDE], gps[GPS_LATITUDE_REF])
        lon = dms_to_deg(gps[GPS_LONGITUDE], gps[GPS_LONGITUDE_REF])
    except (KeyError, IndexError):
        return None
    return (lon, lat)


def rotate_by_roll_pitch_yaw(
    cam_to_world: np.ndarray, roll: float, pitch: float, yaw: float
) -> np.ndarray:
    """A camera-frame roll / pitch / yaw (degrees) applied to a
    cam-to-world transform: the rotation composes on the camera side, so
    a rig member's orientation is relative to the rig."""
    rot = rotation_rpy_to_matrix(roll, pitch, yaw)
    out = np.array(cam_to_world, dtype=np.float64)
    out[:3, :3] = out[:3, :3] @ rot
    return out


def perspective_from_equirectangular(
    equirect_image: np.ndarray,
    roll: float,
    pitch: float,
    yaw: float,
    fov_deg: float = 90.0,
    out_size: typing.Tuple[int, int] = (1024, 1024),
    oversample: float = 1.0,
    return_sampled_mask: bool = False,
):
    """A pinhole view sampled out of a 360 panorama.

    A ray grid of the virtual camera (horizontal field of view
    ``fov_deg``, ``out_size`` = (height, width)) is turned by (roll,
    pitch, yaw) degrees, converted to longitude and latitude, and samples
    the (He, We[, C]) panorama bilinearly, longitude wrapped and latitude
    clamped to the first and last rows.  With ``oversample`` the view is
    sampled at that multiple of ``out_size`` and area-downsampled; with
    ``return_sampled_mask`` also the (He, We) bool mask of the panorama
    pixels nearest a sample.
    """
    from geograypher_tpu_torch.cameras.distortion import bilinear_wrapped

    he, we = equirect_image.shape[:2]
    oh, ow = int(out_size[0] * oversample), int(out_size[1] * oversample)
    f = (ow / 2) / np.tan(np.deg2rad(fov_deg) / 2)

    xs = (np.arange(ow) + 0.5) - ow / 2
    ys = (np.arange(oh) + 0.5) - oh / 2
    xx, yy = np.meshgrid(xs, ys)
    rays = np.stack([xx, yy, np.full_like(xx, f)], axis=-1)
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    rays = rays @ rotation_rpy_to_matrix(roll, pitch, yaw).T

    # camera frame x right, y down, z forward: longitude from atan2(x, z),
    # latitude from asin(y)
    lon = np.arctan2(rays[..., 0], rays[..., 2])
    lat = np.arcsin(np.clip(rays[..., 1], -1, 1))
    map_x = ((lon / (2 * np.pi)) + 0.5) * we - 0.5
    # latitude clamps: a row past either pole would blend the other pole
    map_y = np.clip(((lat / np.pi) + 0.5) * he - 0.5, 0.0, he - 1.0)

    out = bilinear_wrapped(np.asarray(equirect_image), map_y.astype(np.float32),
                           map_x.astype(np.float32))
    if oversample != 1.0:
        from geograypher_tpu_torch.utils.io import resize_area

        out = resize_area(out, out_size[1], out_size[0])
    if return_sampled_mask:
        mask = np.zeros((he, we), dtype=bool)
        xi = np.clip(np.round(map_x).astype(int) % we, 0, we - 1)
        yi = np.clip(np.round(map_y).astype(int), 0, he - 1)
        mask[yi.ravel(), xi.ravel()] = True
        return out, mask
    return out
