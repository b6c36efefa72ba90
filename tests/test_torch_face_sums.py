"""The fixed-order per-face float sum (``ops/face_sums.py``) on the CPU: its
plain version against the JAX package's ``segment_sum`` paths
(``ops/aggregate.py`` ``project_image_to_faces``, ``face_to_vert_texture``)
and against sums taken one value at a time in the two-level tile order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geograypher_tpu.ops import aggregate as jagg
from geograypher_tpu_torch.ops import aggregate as tagg
from geograypher_tpu_torch.ops import face_sums as fs
from tests.test_torch_rasterize import one_torch_thread  # noqa: F401


def two_level_sums(keys, values, n_segments, shape=None):
    """float32 sums and counts in the two-level order, one value at a time:
    a key's finite values within each tile (32 x 32 pixels of ``shape``,
    else runs of 1024 entries) in index order from 0.0, then its per-tile
    partials in tile order from 0.0."""
    n, c = values.shape
    (h, w), (th, tw) = (shape, (32, 32)) if shape else ((1, n), (1, 1024))
    ntx = -(-w // tw)
    partials = {}
    for i, (k, row) in enumerate(zip(keys, values)):
        if 0 <= k < n_segments:
            y, x = divmod(i, w)
            s, cnt = partials.setdefault((int(k), y // th * ntx + x // tw),
                                         (np.zeros(c, np.float32), np.zeros(c, np.int32)))
            ok = np.isfinite(row)
            s[ok] = (s[ok] + row[ok]).astype(np.float32)
            cnt[ok] += 1
    sums = np.zeros((n_segments, c), np.float32)
    counts = np.zeros((n_segments, c), np.int32)
    for (k, _), (s, cnt) in sorted(partials.items()):
        sums[k] = (sums[k] + s).astype(np.float32)
        counts[k] += cnt
    return sums, counts


def random_input(n, n_segments, c, seed, pattern="random"):
    rng = np.random.default_rng(seed)
    keys = rng.integers(-3, n_segments + 3, n).astype(np.int32)
    if pattern == "one_face":  # one key over every tile, a few holes
        keys[:] = n_segments - 1
        keys[rng.random(n) < 0.05] = -1
    elif pattern == "background":
        keys[:] = -1
    values = (rng.standard_normal((n, c)) * 10.0 ** rng.integers(-3, 4, (n, c)))
    values = values.astype(np.float32)
    values[rng.random((n, c)) < 0.05] = np.nan
    values[rng.random((n, c)) < 0.01] = np.inf
    return keys, values


@pytest.mark.parametrize("n,n_segments,c,shape,pattern", [
    (1, 1, 1, None, "random"), (500, 7, 3, None, "random"),
    (4000, 300, 1, None, "random"), (3000, 5, 10, None, "random"),
    (64, 200, 2, None, "random"), (0, 4, 2, None, "random"),
    # 2-D images whose sides are no multiples of the 32 x 32 tile
    (70 * 45, 50, 3, (70, 45), "random"), (33 * 97, 400, 1, (33, 97), "random"),
    (100 * 130, 9, 10, (100, 130), "random"),
    # one face over every tile (20 tiles of an image, 3 runs of a list)
    (100 * 130, 5, 10, (100, 130), "one_face"), (2500, 4, 1, None, "one_face"),
    (40 * 50, 6, 2, (40, 50), "background"),
    # keys past 2^21: the kernel packs them in 64-bit words
    (3000, 2**21 + 7, 2, (50, 60), "random"), (3000, 2**21 + 7, 1, None, "random"),
])
def test_plain_equals_sequential_sums(n, n_segments, c, shape, pattern):
    """Bit for bit the sums a loop takes value by value in the two-level
    order (within a tile in index order, then tile by tile); keys out of
    range dropped, non-finite values skipped and not counted, empty
    segments 0."""
    keys, values = random_input(n, n_segments, c, n + c, pattern)
    if n_segments > 2**21:
        keys[::3] = 2**21 + 5  # keys beyond 2^21 besides the small ones
    sums, counts = fs.face_sums(torch.as_tensor(keys), torch.as_tensor(values),
                                n_segments, shape=shape)
    want_sums, want_counts = two_level_sums(keys, values, n_segments, shape)
    assert sums.dtype == torch.float32 and counts.dtype == torch.int32
    assert torch.equal(sums, torch.as_tensor(want_sums))
    assert torch.equal(counts, torch.as_tensor(want_counts))
    if pattern == "background":
        assert not sums.any() and not counts.any()


def test_tiles_fix_the_order():
    """One key over a 64 x 64 image of values whose sum depends on the
    order: the 2-D tiling (four 32 x 32 tiles) and the 1-D runs (four rows
    of 1024) give the two models' sums, which differ."""
    rng = np.random.default_rng(11)
    values = (rng.standard_normal((64 * 64, 1)) * 10.0 ** rng.integers(-4, 5, (64 * 64, 1)))
    values = values.astype(np.float32)
    keys = np.zeros(64 * 64, np.int32)
    got_2d = fs.face_sums(torch.as_tensor(keys), torch.as_tensor(values), 1,
                          shape=(64, 64))[0].numpy()
    got_1d = fs.face_sums(torch.as_tensor(keys), torch.as_tensor(values), 1)[0].numpy()
    assert np.array_equal(got_2d, two_level_sums(keys, values, 1, (64, 64))[0])
    assert np.array_equal(got_1d, two_level_sums(keys, values, 1)[0])
    assert not np.array_equal(got_2d, got_1d)


def test_means_path_equals_jax_and_is_reproducible():
    """``project_image_to_faces`` against the JAX package's segment_sum to
    rtol 1e-6 (counts exactly), and two runs bit for bit."""
    rng = np.random.default_rng(5)
    h, w, c, n_faces = 48, 64, 3, 400
    p2f = rng.integers(-1, n_faces, (h, w)).astype(np.int32)
    p2f[:, :9] = 17  # one face with a long run of pixels
    img = rng.random((h, w, c)).astype(np.float32) * 100.0
    img[rng.random((h, w)) < 0.1] = np.nan
    want_sums, want_counts = jagg.project_image_to_faces(
        jnp.asarray(p2f), jnp.asarray(img), n_faces)
    runs = [tagg.project_image_to_faces(torch.as_tensor(p2f), torch.as_tensor(img),
                                        n_faces) for _ in range(2)]
    for sums, counts in runs:
        np.testing.assert_allclose(sums.numpy(), np.asarray(want_sums), rtol=1e-6)
        np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    # a 2-D image is one channel
    sums2, counts2 = tagg.project_image_to_faces(
        torch.as_tensor(p2f), torch.as_tensor(img[..., 0]), n_faces)
    assert torch.equal(sums2[:, 0], runs[0][0][:, 0])


def test_face_to_vert_texture_equals_jax():
    """Per-vertex means of adjacent faces; a face with any non-finite
    channel does not vote; a vertex no face votes for is NaN."""
    rng = np.random.default_rng(6)
    n_verts, n_faces = 60, 90
    faces = rng.integers(0, n_verts - 5, (n_faces, 3)).astype(np.int64)
    tex = rng.random((n_faces, 2)).astype(np.float32)
    tex[::7, 1] = np.nan
    want = np.asarray(jagg.face_to_vert_texture(jnp.asarray(faces), jnp.asarray(tex),
                                                n_verts))
    got = tagg.face_to_vert_texture(torch.as_tensor(faces), torch.as_tensor(tex),
                                    n_verts).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[-5:]).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, equal_nan=True)
    got1 = tagg.face_to_vert_texture(torch.as_tensor(faces),
                                     torch.as_tensor(tex[:, 0]), n_verts)
    assert got1.shape == (n_verts, 1)


def test_face_sums_refuses_what_the_kernel_does_not_take():
    keys = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="float32"):
        fs.face_sums(keys, torch.zeros((4, 2), dtype=torch.float64), 3)
    with pytest.raises(ValueError, match="keys"):
        fs.face_sums(keys.float(), torch.zeros((4, 2)), 3)
    with pytest.raises(ValueError, match="values"):
        fs.face_sums(keys, torch.zeros((5, 2)), 3)
    with pytest.raises(ValueError, match="shape"):
        fs.face_sums(keys, torch.zeros((4, 2)), 3, shape=(3, 2))
    with pytest.raises(ValueError, match="n_segments"):
        fs.face_sums(keys, torch.zeros((4, 2)), 2**31)
