"""A plain PNG reader: the chunks, ``zlib`` from the standard library, and
the five row filters of the PNG specification, for 8-bit gray, RGB and
RGBA images without interlacing."""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 6: 4}


def decode(data: bytes) -> np.ndarray:
    """(H, W) or (H, W, C) uint8 pixels of a PNG file's bytes; raises
    ``ValueError`` for anything else."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if zlib.crc32(kind + body) != struct.unpack(">I", data[pos + 8 + length:
                                                             pos + 12 + length])[0]:
            raise ValueError(f"bad CRC in a {kind!r} chunk")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise ValueError("no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color not in CHANNELS or interlace:
        raise ValueError(f"unsupported PNG: depth {depth}, colour {color}, "
                         f"interlace {interlace}")
    bpp = CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = raw.reshape(height, 1 + width * bpp)
    out = _unfilter(rows[:, 0], rows[:, 1:].astype(np.int64), bpp)
    return out.reshape(height, width) if bpp == 1 else out.reshape(height, width, bpp)


def _unfilter(filters: np.ndarray, rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo each row's filter (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    out = np.zeros_like(rows)
    prev = np.zeros(rows.shape[1], np.int64)
    for r, kind in enumerate(filters):
        row = rows[r]
        if kind == 0:
            cur = row
        elif kind == 1:
            cur = np.cumsum(row.reshape(-1, bpp), axis=0).reshape(-1) % 256
        elif kind == 2:
            cur = (row + prev) % 256
        elif kind in (3, 4):
            cur = row.copy()
            for x in range(len(cur)):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                if kind == 3:
                    pred = (a + b) // 2
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) % 256
        else:
            raise ValueError(f"row {r}: unknown filter type {kind}")
        out[r] = cur
        prev = cur
    return out.astype(np.uint8)
