"""Mesh file IO: PLY (ASCII + binary), OBJ and .npz, numpy-native.

The port's own copy of ``load_mesh`` and ``save_mesh`` from
``geograypher_tpu/utils/meshio.py`` and the readers and the PLY writer
they call.  The JAX package's optional C++ PLY reader is not
carried over: the numpy readers here define the same format semantics.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from geograypher_tpu_torch.constants import PATH_TYPE
from geograypher_tpu_torch.utils.files import ensure_containing_folder

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def load_mesh(
    filename: PATH_TYPE,
) -> Tuple[np.ndarray, np.ndarray, Dict[str, np.ndarray]]:
    """Load a mesh file.

    Returns:
        verts: (V, 3) float64
        faces: (F, 3) int32 (polygons are fan-triangulated)
        attrs: extra per-vertex attributes (e.g. colors) by name
    """
    filename = Path(filename)
    suffix = filename.suffix.lower()
    if suffix == ".ply":
        return _load_ply(filename)
    if suffix == ".obj":
        return _load_obj(filename)
    if suffix in (".npz",):
        data = np.load(filename)
        attrs = {
            k: data[k] for k in data.files if k not in ("verts", "faces")
        }
        return (
            data["verts"].astype(np.float64),
            data["faces"].astype(np.int32),
            attrs,
        )
    raise ValueError(f"Unsupported mesh format: {suffix}")


def save_mesh(
    filename: PATH_TYPE,
    verts: np.ndarray,
    faces: np.ndarray,
    vert_colors: Optional[np.ndarray] = None,
    binary: bool = True,
) -> None:
    """Save a triangle mesh as PLY (or .npz)."""
    filename = ensure_containing_folder(filename)
    if filename.suffix.lower() == ".npz":
        np.savez(filename, verts=verts, faces=faces)
        return
    if filename.suffix.lower() != ".ply":
        raise ValueError(f"Unsupported save format: {filename.suffix}")
    _save_ply(filename, verts, faces, vert_colors, binary=binary)


# ---------------------------------------------------------------------------


def _parse_ply_header(fh):
    magic = fh.readline().strip()
    if magic != b"ply":
        raise ValueError("Not a PLY file")
    fmt = None
    elements = []  # (name, count, [(prop_name, dtype, is_list, count_dtype)])
    while True:
        line = fh.readline()
        if not line:
            raise ValueError("Unexpected EOF in PLY header")
        tokens = line.decode("ascii", "replace").strip().split()
        if not tokens or tokens[0] == "comment":
            continue
        if tokens[0] == "format":
            fmt = tokens[1]
        elif tokens[0] == "element":
            elements.append((tokens[1], int(tokens[2]), []))
        elif tokens[0] == "property":
            if tokens[1] == "list":
                elements[-1][2].append(
                    (tokens[4], _PLY_DTYPES[tokens[3]], True, _PLY_DTYPES[tokens[2]])
                )
            else:
                elements[-1][2].append(
                    (tokens[2], _PLY_DTYPES[tokens[1]], False, None)
                )
        elif tokens[0] == "end_header":
            break
    return fmt, elements


def _load_ply(filename: Path):
    with open(filename, "rb") as fh:
        fmt, elements = _parse_ply_header(fh)
        if fmt == "ascii":
            return _load_ply_ascii(fh, elements)
        endian = "<" if fmt == "binary_little_endian" else ">"
        return _load_ply_binary(fh, elements, endian)


def _extract(verts_rec, face_list):
    verts = np.stack(
        [verts_rec["x"], verts_rec["y"], verts_rec["z"]], axis=1
    ).astype(np.float64)
    attrs = {}
    names = verts_rec.dtype.names
    if all(c in names for c in ("red", "green", "blue")):
        attrs["colors"] = np.stack(
            [verts_rec["red"], verts_rec["green"], verts_rec["blue"]], axis=1
        )
    for n in names:
        if n not in ("x", "y", "z", "red", "green", "blue"):
            attrs[n] = np.asarray(verts_rec[n])
    return verts, face_list, attrs


def _triangulate_fans(polys: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Fan-triangulate variable-length polygons given as a flat index array."""
    if lengths.size == 0:
        return np.zeros((0, 3), np.int32)
    if (lengths == 3).all():
        return polys.reshape(-1, 3).astype(np.int32)
    tris = []
    pos = 0
    for n in lengths:
        ring = polys[pos : pos + n]
        for k in range(1, n - 1):
            tris.append((ring[0], ring[k], ring[k + 1]))
        pos += n
    return np.asarray(tris, dtype=np.int32)


def _load_ply_binary(fh, elements, endian):
    verts_rec = None
    faces = None
    # bytes over-read by a list-property parse, consumed before touching
    # the file again (elements CAN follow the face element per the spec)
    leftover = b""

    def read_bytes(n):
        nonlocal leftover
        if len(leftover) >= n:
            out, leftover = leftover[:n], leftover[n:]
            return out
        out = leftover + fh.read(n - len(leftover))
        leftover = b""
        return out

    for name, count, props in elements:
        if all(not p[2] for p in props):
            dt = np.dtype([(p[0], endian + p[1]) for p in props])
            rec = np.frombuffer(read_bytes(dt.itemsize * count), dtype=dt)
            if name == "vertex":
                verts_rec = rec
        else:
            # list property (face element); read adaptively
            assert name == "face" or faces is None
            if count == 0:  # point-cloud PLYs declare 'element face 0'
                if name == "face":
                    faces = np.zeros((0, 3), np.int32)
                continue
            cnt_dt = np.dtype(endian + props[0][3])
            idx_dt = np.dtype(endian + props[0][1])
            # Fast path: peek first polygon size, assume uniform, verify
            raw = leftover + fh.read()
            leftover = b""
            first = int(np.frombuffer(raw[: cnt_dt.itemsize], dtype=cnt_dt)[0])
            stride = cnt_dt.itemsize + first * idx_dt.itemsize
            if count * stride <= len(raw):
                rec = np.frombuffer(raw[: count * stride], dtype=np.uint8)
                rec = rec.reshape(count, stride)
                cnts = rec[:, : cnt_dt.itemsize].copy().view(cnt_dt)[:, 0]
                if (cnts == first).all():
                    idx = (
                        rec[:, cnt_dt.itemsize :]
                        .copy()
                        .view(idx_dt)
                        .astype(np.int64)
                    )
                    faces = _triangulate_fans(idx.reshape(-1), np.full(count, first))
                    leftover = raw[count * stride :]
                    continue
            # Slow path: per-polygon parse
            pos = 0
            polys, lens = [], []
            for _ in range(count):
                (n,) = struct.unpack_from(
                    endian + {1: "b", 2: "h", 4: "i"}[cnt_dt.itemsize], raw, pos
                )
                pos += cnt_dt.itemsize
                polys.append(
                    np.frombuffer(raw, dtype=idx_dt, count=n, offset=pos)
                )
                pos += n * idx_dt.itemsize
                lens.append(n)
            faces = _triangulate_fans(
                np.concatenate(polys), np.asarray(lens)
            )
            leftover = raw[pos:]
    if verts_rec is None:
        raise ValueError("PLY has no vertex element")
    if faces is None:
        faces = np.zeros((0, 3), np.int32)
    return _extract(verts_rec, faces)


def _load_ply_ascii(fh, elements):
    text = fh.read().decode("ascii")
    tokens = text.split()
    pos = 0
    verts_rec = None
    faces = None
    for name, count, props in elements:
        if all(not p[2] for p in props):
            width = len(props)
            arr = np.array(tokens[pos : pos + count * width], dtype=np.float64)
            pos += count * width
            arr = arr.reshape(count, width)
            dt = np.dtype([(p[0], p[1]) for p in props])
            rec = np.zeros(count, dtype=dt)
            for i, p in enumerate(props):
                rec[p[0]] = arr[:, i]
            if name == "vertex":
                verts_rec = rec
        else:
            polys, lens = [], []
            for _ in range(count):
                n = int(tokens[pos])
                pos += 1
                polys.append([int(t) for t in tokens[pos : pos + n]])
                pos += n
                lens.append(n)
            faces = _triangulate_fans(
                np.concatenate([np.asarray(p) for p in polys])
                if polys
                else np.zeros((0,), np.int64),
                np.asarray(lens),
            )
    if faces is None:
        faces = np.zeros((0, 3), np.int32)
    return _extract(verts_rec, faces)


def _save_ply(filename, verts, faces, vert_colors=None, binary=True):
    verts = np.asarray(verts)
    faces = np.asarray(faces, dtype=np.int32)
    has_color = vert_colors is not None
    header = ["ply"]
    header.append(
        "format binary_little_endian 1.0" if binary else "format ascii 1.0"
    )
    header += [
        f"element vertex {len(verts)}",
        "property double x",
        "property double y",
        "property double z",
    ]
    if has_color:
        header += [
            "property uchar red",
            "property uchar green",
            "property uchar blue",
        ]
    header += [
        f"element face {len(faces)}",
        "property list uchar int vertex_indices",
        "end_header",
    ]
    with open(filename, "wb") as fh:
        fh.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            if has_color:
                dt = np.dtype(
                    [("x", "<f8"), ("y", "<f8"), ("z", "<f8"),
                     ("r", "u1"), ("g", "u1"), ("b", "u1")]
                )
                rec = np.zeros(len(verts), dtype=dt)
                rec["x"], rec["y"], rec["z"] = verts.T
                colors = np.asarray(vert_colors).astype(np.uint8)
                rec["r"], rec["g"], rec["b"] = colors[:, :3].T
                fh.write(rec.tobytes())
            else:
                fh.write(verts.astype("<f8").tobytes())
            fdt = np.dtype([("n", "u1"), ("a", "<i4"), ("b", "<i4"), ("c", "<i4")])
            frec = np.zeros(len(faces), dtype=fdt)
            frec["n"] = 3
            frec["a"], frec["b"], frec["c"] = faces.T
            fh.write(frec.tobytes())
        else:
            for i, v in enumerate(verts):
                line = f"{v[0]} {v[1]} {v[2]}"
                if has_color:
                    c = np.asarray(vert_colors[i]).astype(int)
                    line += f" {c[0]} {c[1]} {c[2]}"
                fh.write((line + "\n").encode())
            for f in faces:
                fh.write(f"3 {f[0]} {f[1]} {f[2]}\n".encode())


def _load_obj(filename: Path):
    verts = []
    faces = []
    with open(filename) as fh:
        for line in fh:
            if line.startswith("v "):
                verts.append([float(t) for t in line.split()[1:4]])
            elif line.startswith("f "):
                # OBJ indices are 1-based; negative values are relative
                # to the vertices read so far ("f -4 -3 -2")
                raw_idx = [int(t.split("/")[0]) for t in line.split()[1:]]
                idx = [
                    i - 1 if i > 0 else len(verts) + i for i in raw_idx
                ]
                for k in range(1, len(idx) - 1):
                    faces.append((idx[0], idx[k], idx[k + 1]))
    return (
        np.asarray(verts, dtype=np.float64),
        np.asarray(faces, dtype=np.int32),
        {},
    )
