"""The reference's PNG reader against the port's writer and every row
filter of the PNG specification."""

import struct
import zlib

import numpy as np
import pytest

from benchmark.reference import png


def _encode(img: np.ndarray, kind: int) -> bytes:
    """A gray PNG whose every row carries filter ``kind``."""
    h, w = img.shape
    raw, prev = [], np.zeros(w, np.int64)
    for r in range(h):
        row = img[r].astype(np.int64)
        a = np.concatenate([[0], row[:-1]])
        c = np.concatenate([[0], prev[:-1]])
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (a + prev) // 2
        else:
            p = a + prev - c
            pa, pb, pc = abs(p - a), abs(p - prev), abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        raw.append(np.concatenate([[kind], (row - pred) % 256]).astype(np.uint8))
        prev = row

    def chunk(k, body):
        return (struct.pack(">I", len(body)) + k + body
                + struct.pack(">I", zlib.crc32(k + body)))

    return (png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(np.concatenate(raw).tobytes()))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_every_filter(kind):
    img = np.random.default_rng(kind).integers(0, 256, (13, 29), dtype=np.uint8)
    assert np.array_equal(png.decode(_encode(img, kind)), img)


def test_the_ports_writer():
    from geograypher_tpu_torch.utils.io import encode_png

    gen = np.random.default_rng(0)
    gray = gen.integers(0, 256, (37, 53), dtype=np.uint8)
    rgb = gen.integers(0, 256, (17, 23, 3), dtype=np.uint8)
    assert np.array_equal(png.decode(encode_png(gray)), gray)
    assert np.array_equal(png.decode(encode_png(rgb)), rgb)


def test_a_damaged_file_is_refused():
    data = bytearray(_encode(np.zeros((4, 4), np.uint8), 0))
    data[40] ^= 0xFF
    with pytest.raises(ValueError):
        png.decode(bytes(data))
