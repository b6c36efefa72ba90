"""The setup kernel's launch path on the CPU: the one output buffer's
layout and views, and the C entry point's arguments.

On the card ``triangle_setup`` allocates one buffer of 65 bytes a face
and cuts it into the planes, the boxes and the validity
(``ops/tri_setup.py`` ``setup_layout``), the layout
``csrc/triangle_setup.cu`` writes; the kernel itself is held bit-equal to
the plain version in ``tests/test_torch_kernels_gpu.py``."""

import pytest
import torch

from geograypher_tpu_torch.ops import tri_setup
from tests.test_torch_rasterize import one_torch_thread  # noqa: F401

SIZES = [0, 1, 999_698]  # 999,698: the bench mesh


@pytest.mark.parametrize("n", SIZES)
def test_layout_offsets_are_16_byte_aligned(n):
    """Planes at 0, boxes at 48 n, validity at 64 n, 65 n bytes in all
    rounded up to 16."""
    layout = tri_setup.setup_layout(n)
    assert layout[:3] == (0, 48 * n, 64 * n)
    assert 65 * n <= layout[3] < 65 * n + 16
    assert all(at % 16 == 0 for at in layout)


@pytest.mark.parametrize("n", SIZES)
def test_outputs_are_views_of_one_buffer(n):
    """Shapes, dtypes, strides and byte offsets of the three views; each
    writes its own bytes of the buffer and no other's."""
    buffer, setup = tri_setup._outputs(n, torch.device("cpu"))
    size = tri_setup.setup_layout(n)[-1]
    assert buffer.dtype == torch.float32 and buffer.shape == (size // 4,)
    assert [tuple(t.shape) for t in setup] == [(n, 12), (4, n), (n,)]
    assert [t.dtype for t in setup] == [torch.float32, torch.int32, torch.bool]
    assert [t.stride() for t in setup] == [(12, 1), (n, 1), (1,)]
    assert all(t.is_contiguous() for t in setup)
    base = buffer.data_ptr()
    assert all(t.untyped_storage().data_ptr() == buffer.untyped_storage().data_ptr()
               for t in setup)
    starts = [t.data_ptr() - base for t in setup]
    assert starts == list(tri_setup.setup_layout(n)[:3])
    assert all(s % 16 == 0 for s in starts)
    raw = buffer.view(torch.uint8)
    raw.zero_()
    setup.planes.fill_(-1.0)  # 0xBF800000: bytes 00 00 80 BF
    setup.bbox.fill_(0x01010101)
    setup.valid.fill_(True)
    planes_bytes = torch.tensor([0, 0, 0x80, 0xBF], dtype=torch.uint8).repeat(12 * n)
    assert torch.equal(raw[:48 * n], planes_bytes)
    assert bool((raw[48 * n:65 * n] == 1).all()) and not raw[65 * n:].any()


@pytest.mark.parametrize("f_kind", ["host", "tensor"])
@pytest.mark.parametrize("lens", [False, True])
def test_checked_gives_the_c_arguments(lens, f_kind):
    """f as a device pointer or a host number (the other null / 0.0), the
    lens terms as three pointers or three nulls."""
    rows, w2c = torch.zeros((9, 4)), torch.eye(4)
    f = torch.tensor(2.0) if f_kind == "tensor" else 2
    dist = ((torch.zeros(8), torch.tensor(0.5), torch.tensor(-0.5)) if lens else None)
    got = tri_setup._checked(rows, w2c, f, dist)
    if f_kind == "tensor":
        assert got[:2] == (f.data_ptr(), 0.0)
    else:
        assert got[:2] == (None, 2.0) and isinstance(got[1], float)
    assert got[2:] == (tuple(t.data_ptr() for t in dist) if lens else (None,) * 3)


def test_launch_path_with_no_faces_launches_nothing():
    """Zero faces: empty outputs of the right shapes, no build, no launch."""
    before = tri_setup.launches
    out = tri_setup._launch(torch.zeros((9, 0)), torch.eye(4), 2.0, 32, 32, 1e-6, None)
    assert [tuple(t.shape) for t in out] == [(0, 12), (4, 0), (0,)]
    assert tri_setup.launches == before
