"""Triangle setup: the fused setup kernel's wrapper and its plain version.

:func:`triangle_setup` turns (9, F) coordinate rows and one camera into
per-face raster planes, pixel boxes and validity (:class:`TriangleSetup`).
On a CUDA tensor it launches the hand-written kernel
``csrc/triangle_setup.cu``; on a CPU tensor it runs
:func:`setup_from_soa_plain`, about sixty elementwise PyTorch ops.

Kernel source note.  Replaces no TPU kernel: the JAX package's
``setup_from_soa`` (``geograypher_tpu/ops/rasterize.py:200``) runs inside
one jitted program that XLA fuses into a few kernels, where the port's
eager version launches one kernel per op over all F faces.  On the H100
the work is bound by bytes: 9 float32 read and 12 plane floats, 4 int32
box bounds and one valid byte written a face (101 bytes; 101 MB at 1M
faces, 0.030 ms at 3.35 TB/s).  The kernel is one launch a view, one
thread a face; a block stages its plane rows in shared memory and writes
them out as whole lines, and reads the camera and the lens terms from
device memory once (no host read).  It is bit-equal to the plain version
on the card: every product and sum is rounded on its own
(``__fmul_rn``, ``__fadd_rn``, no FMA contraction) in the plain
version's order, the divisions are the correctly rounded ones PyTorch's
kernels make, and each scalar enters as the float32 value PyTorch casts
it to (a Python number divides by multiplying with its float32
reciprocal, as PyTorch's CUDA division by a host scalar does).

The launch path is short because the main path launches the setup once
for every view it censuses and runs: one allocation of 65 bytes a face,
cut into the three outputs (:func:`setup_layout`); no device context
(the C entry point makes the rows' device current only when it is not);
one lookup of the current stream; plain numbers to ``ctypes``.
"""

from __future__ import annotations

import numbers
from typing import NamedTuple

import torch

from geograypher_tpu_torch.kernels import build

# kernel launches since the last reset (the main path's proof of use)
launches = 0


class TriangleSetup(NamedTuple):
    """Per-view screen-space triangle data."""

    planes: torch.Tensor  # (F, 12): 3 edge planes + the 1/z plane
    bbox: torch.Tensor  # (4, F) int32 rows: first/last covered row & col
    valid: torch.Tensor  # (F,) bool


def setup_from_soa_plain(
    tri_soa: torch.Tensor,
    world_to_cam: torch.Tensor,
    f,
    image_w: int,
    image_h: int,
    znear: float = 1e-6,
    distortion=None,
) -> TriangleSetup:
    """Plain PyTorch setup: camera transform + screen projection + raster
    planes on (9, F) rows (see :func:`triangle_setup`)."""
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


def setup_layout(n: int):
    """Byte offsets of the planes, the boxes and the validity in the one
    output buffer of an ``n``-face launch, and its size: the planes
    (n, 12) float32 at 0, the boxes (4, n) int32 at 48 n, the validity
    (n,) bool at 64 n; 65 n bytes, rounded up to a multiple of 16 (every
    offset is one).  ``csrc/triangle_setup.cu`` writes the same layout."""
    return 0, 48 * n, 64 * n, (65 * n + 15) // 16 * 16


def _views(buffer, n):
    """The three outputs of an ``n``-face launch as views of its float32
    ``buffer`` (``setup_layout``): five view calls, ``as_strided`` on the
    buffer's dtype views, the fewest that cut three dtypes out of one
    allocation."""
    return TriangleSetup(
        planes=buffer.as_strided((n, 12), (12, 1)),
        bbox=buffer.view(torch.int32).as_strided((4, n), (n, 1), 12 * n),
        valid=buffer.view(torch.bool).as_strided((n,), (1,), 64 * n))


def _outputs(n: int, device):
    """(buffer, its TriangleSetup views): the launch's one allocation."""
    buffer = torch.empty(setup_layout(n)[-1] // 4, dtype=torch.float32, device=device)
    return buffer, _views(buffer, n)


def _device_scalar(name, value, device):
    """A float32 one-element tensor on ``device`` (its pointer for the
    kernel), or raise."""
    if (not isinstance(value, torch.Tensor) or value.dtype != torch.float32
            or value.numel() != 1 or value.device != device):
        got = (f"{value.dtype} {tuple(value.shape)} on {value.device}"
               if isinstance(value, torch.Tensor) else type(value).__name__)
        raise ValueError(f"triangle_setup: {name} must be a float32 one-element "
                         f"tensor on {device}, got {got}")
    return value.data_ptr()


def triangle_setup(
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

    A CUDA tensor launches the CUDA kernel (or raises); only a CPU tensor
    runs the plain version.  The kernel takes float32 rows (9, F), a
    float32 (4, 4) ``world_to_cam``, ``f`` as a number or a float32
    one-element tensor, and with distortion ``dist8`` (8,) and ``pcx``,
    ``pcy`` as float32 tensors, all contiguous on the rows' device.
    """
    if tri_soa.device.type == "cpu":
        return setup_from_soa_plain(tri_soa, world_to_cam, f, image_w, image_h,
                                    znear, distortion)
    if tri_soa.device.type != "cuda":
        raise ValueError(f"triangle_setup: unsupported device {tri_soa.device}")
    return _launch(tri_soa, world_to_cam, f, image_w, image_h, znear, distortion)


def _checked(tri_soa, world_to_cam, f, distortion):
    """Check what the kernel takes; return the C entry point's f and lens
    arguments (f_dev, f_host, dist8, pcx, pcy): pointers, None where
    absent, and the host f (0.0 for a tensor f)."""
    dev = tri_soa.device
    if (tri_soa.dtype != torch.float32 or tri_soa.ndim != 2 or tri_soa.shape[0] != 9
            or not tri_soa.is_contiguous()):
        raise ValueError(f"tri_soa must be a contiguous float32 (9, F), got "
                         f"{tri_soa.dtype} {tuple(tri_soa.shape)}")
    if (world_to_cam.dtype != torch.float32 or world_to_cam.shape != (4, 4)
            or world_to_cam.device != dev or not world_to_cam.is_contiguous()):
        raise ValueError(f"world_to_cam must be a contiguous float32 (4, 4) tensor on "
                         f"{dev}, got {world_to_cam.dtype} {tuple(world_to_cam.shape)} "
                         f"on {world_to_cam.device}")
    if isinstance(f, torch.Tensor):
        f_args = (_device_scalar("f", f, dev), 0.0)
    elif isinstance(f, (float, int, numbers.Real)):  # the ABC's check last: slower
        # the C entry point takes the number as PyTorch does where it meets
        # a float32 tensor: rounded to float32, a division by f * f made a
        # multiply by its float32 reciprocal
        f_args = (None, float(f))
    else:
        raise ValueError(f"triangle_setup: f must be a number or a tensor, got "
                         f"{type(f).__name__}")
    if distortion is None:
        return f_args + (None, None, None)
    dist8, pcx, pcy = distortion
    if (not isinstance(dist8, torch.Tensor) or dist8.dtype != torch.float32
            or dist8.shape != (8,) or dist8.device != dev or not dist8.is_contiguous()):
        raise ValueError(f"triangle_setup: dist8 must be a contiguous float32 (8,) "
                         f"tensor on {dev}")
    return f_args + (dist8.data_ptr(), _device_scalar("pcx", pcx, dev),
                     _device_scalar("pcy", pcy, dev))


def _launch(tri_soa, world_to_cam, f, image_w, image_h, znear, distortion):
    """Check the kernel's inputs, allocate its outputs and launch it."""
    global launches
    scalars = _checked(tri_soa, world_to_cam, f, distortion)
    n = tri_soa.shape[1]
    dev = tri_soa.device
    buffer, out = _outputs(n, dev)
    if n == 0:
        return out
    err = build.load().gg_triangle_setup(
        tri_soa.data_ptr(), n, world_to_cam.data_ptr(), *scalars, znear, image_w,
        image_h, buffer.data_ptr(), dev.index, build.raw_stream(dev.index))
    build.check(err, "gg_triangle_setup")
    launches += 1
    return out
