"""The fixed-order per-face float sum (``ops/face_sums.py``) on the CPU: its
plain version against the JAX package's ``segment_sum`` paths
(``ops/aggregate.py`` ``project_image_to_faces``, ``face_to_vert_texture``)
and against sums taken one value at a time in index order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geograypher_tpu.ops import aggregate as jagg
from geograypher_tpu_torch.ops import aggregate as tagg
from geograypher_tpu_torch.ops import face_sums as fs
from tests.test_torch_rasterize import one_torch_thread  # noqa: F401


def sequential_sums(keys, values, n_segments):
    """float32 sums and counts, one value at a time in index order."""
    sums = np.zeros((n_segments, values.shape[1]), np.float32)
    counts = np.zeros((n_segments, values.shape[1]), np.int32)
    for k, row in zip(keys, values):
        if 0 <= k < n_segments:
            ok = np.isfinite(row)
            sums[k, ok] = (sums[k, ok] + row[ok]).astype(np.float32)
            counts[k, ok] += 1
    return sums, counts


def random_input(n, n_segments, c, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(-3, n_segments + 3, n).astype(np.int32)
    values = (rng.standard_normal((n, c)) * 10.0 ** rng.integers(-3, 4, (n, c)))
    values = values.astype(np.float32)
    values[rng.random((n, c)) < 0.05] = np.nan
    values[rng.random((n, c)) < 0.01] = np.inf
    return keys, values


@pytest.mark.parametrize("n,n_segments,c", [(1, 1, 1), (500, 7, 3), (4000, 300, 1),
                                            (3000, 5, 10), (64, 200, 2), (0, 4, 2)])
def test_plain_equals_sequential_sums(n, n_segments, c):
    """Bit for bit the sums a loop takes value by value in index order;
    keys out of range dropped, non-finite values skipped and not counted,
    empty segments 0."""
    keys, values = random_input(n, n_segments, c, n + c)
    sums, counts = fs.face_sums(torch.as_tensor(keys), torch.as_tensor(values),
                                n_segments)
    want_sums, want_counts = sequential_sums(keys, values, n_segments)
    assert sums.dtype == torch.float32 and counts.dtype == torch.int32
    assert torch.equal(sums, torch.as_tensor(want_sums))
    assert torch.equal(counts, torch.as_tensor(want_counts))


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
