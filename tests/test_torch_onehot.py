"""The port's one-hot label scan (``ops/onehot.py``) against the numpy
scan ``TexturedMesh._as_class_image`` of the JAX package and the port's
copy of it, and ``project_images`` with the scan on the mesh's device
against the JAX package's (CPU: the wrapper runs its plain version; the
CUDA kernel is held against the same plain version on the card by
``tests/test_torch_kernels_gpu.py``).  Every class-image and count
comparison is exact."""

import numpy as np
import pytest
import torch

from geograypher_tpu.cameras.core import CameraSet as JaxCameraSet
from geograypher_tpu.cameras.segmentor_set import (
    SegmentorCameraSet as JaxSegmentorCameraSet,
)
from geograypher_tpu.meshes.mesh import TexturedMesh as JaxTexturedMesh
from geograypher_tpu.ops.rasterize import RasterConfig as JaxRasterConfig
from geograypher_tpu.utils.fixtures import make_grid_mesh, nadir_camera, oblique_camera
from geograypher_tpu_torch import interop
from geograypher_tpu_torch.cameras.segmentor_set import SegmentorCameraSet
from geograypher_tpu_torch.meshes.mesh import TexturedMesh
from geograypher_tpu_torch.ops import face_counts, onehot
from tests.test_torch_rasterize import one_torch_thread  # noqa: F401

H, W, C = 12, 17, 5


def onehot_image(dtype=np.float32, n_classes=C, shape=(H, W), seed=0):
    labels = np.random.default_rng(seed).integers(0, n_classes, shape)
    return np.eye(n_classes, dtype=dtype)[labels]


def with_rows(value):
    img = onehot_image()
    img[2:4] = value
    img[7, 3] = value
    return img


def negative_zeros():
    img = onehot_image()
    img[img == 0] = -0.0
    assert np.signbit(img).any()
    return img


def spoiled(row):
    img = onehot_image()
    img[5, 6] = row
    return img


NAN, INF = np.nan, np.inf
ACCEPTED = {
    "exact": onehot_image,
    "nan_rows": lambda: with_rows(NAN),
    "inf_rows": lambda: with_rows(INF),
    "mixed_nonfinite_rows": lambda: spoiled([NAN, INF, -INF, NAN, INF]),
    "negative_zero": negative_zeros,
    "float64": lambda: onehot_image(np.float64),
    "uint8": lambda: onehot_image(np.uint8),
    "bool": lambda: onehot_image(bool),
    "two_classes": lambda: onehot_image(n_classes=2),
    "empty": lambda: np.zeros((0, W, C), np.float32),
}
REFUSED = {
    "soft_value": lambda: spoiled([0, 0.5, 0, 0, 0]),
    "soft_row_sums_to_one": lambda: spoiled([0.5, 0.5, 0, 0, 0]),
    "two_ones": lambda: spoiled([1, 0, 0, 1, 0]),
    "all_zero_row": lambda: spoiled([0, 0, 0, 0, 0]),
    "nan_beside_zeros": lambda: spoiled([NAN, 0, 0, 0, 0]),
    "one_beside_inf": lambda: spoiled([1, INF, 0, 0, 0]),
    "a_two": lambda: spoiled([0, 2, 0, 0, 0]),
    "uint8_two": lambda: spoiled([0, 2, 0, 0, 0]).astype(np.uint8),
    "float64_soft": lambda: spoiled([0, 0.25, 0, 0.75, 0]).astype(np.float64),
}


def to_device_dtype(img):
    """The host conversion of ``project_images``: float64 stays, every
    other dtype becomes float32."""
    if img.dtype not in (np.float32, np.float64):
        img = img.astype(np.float32)
    return torch.as_tensor(np.ascontiguousarray(img))


@pytest.mark.parametrize("case", sorted(ACCEPTED))
def test_accepted_images_equal_the_numpy_scans(case):
    img = ACCEPTED[case]()
    want = JaxTexturedMesh._as_class_image(img)
    assert want is not None and want.dtype == np.int32
    np.testing.assert_array_equal(TexturedMesh._as_class_image(img), want)
    for fn in (onehot.onehot_to_class_plain, onehot.onehot_to_class):
        cls, violations = fn(to_device_dtype(img))
        assert cls.dtype == torch.int32 and violations.dtype == torch.int32
        assert int(violations) == 0
        np.testing.assert_array_equal(cls.numpy(), want)


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_images_report_violations(case):
    img = REFUSED[case]()
    assert JaxTexturedMesh._as_class_image(img) is None
    assert TexturedMesh._as_class_image(img) is None
    cls, violations = onehot.onehot_to_class(to_device_dtype(img))
    assert int(violations) == 1  # the one spoiled pixel
    assert int(cls[5, 6]) == -1
    # every other pixel keeps its class
    want = JaxTexturedMesh._as_class_image(onehot_image())
    rest = np.ones((H, W), bool)
    rest[5, 6] = False
    np.testing.assert_array_equal(cls.numpy()[rest], want[rest])


def test_violations_count_pixels():
    img = onehot_image()
    img[0, :4] = 0.5
    img[3, 2] = [1, 1, 0, 0, 0]
    img[4] = np.nan  # unlabeled, no violation
    _, violations = onehot.onehot_to_class(torch.as_tensor(img))
    assert int(violations) == 5


def test_onehot_to_class_checks_inputs():
    img = torch.zeros((4, 5, 3))
    with pytest.raises(ValueError, match="float32 or float64"):
        onehot.onehot_to_class(img.to(torch.int32))
    with pytest.raises(ValueError, match="float32 or float64"):
        onehot.onehot_to_class(img.to(torch.float16))
    with pytest.raises(ValueError, match=r"\(H, W, C\)"):
        onehot.onehot_to_class(img[0])
    with pytest.raises(ValueError, match="C >= 2"):
        onehot.onehot_to_class(img[..., :1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        onehot.onehot_to_class(img[..., :2])
    with pytest.raises(ValueError, match="contiguous"):
        onehot.onehot_to_class(img.permute(1, 0, 2))


class Images:
    """A segmentor that serves prepared images by camera index."""

    needs_image = False

    def __init__(self, images):
        self.images = images

    def segment_image(self, image, filename=None, image_scale=1.0, index=None,
                      **kwargs):
        return self.images[index]


PW, PH = 96, 64
XLA = JaxRasterConfig(caps=(256, 96, 48, 32), backend="xla")


@pytest.fixture(scope="module")
def scene():
    verts, faces = make_grid_mesh(
        n=21, size=4.0, z_fn=lambda x, y: 0.15 * np.sin(3 * x) * np.cos(2 * y)
    )
    jmesh = JaxTexturedMesh((verts, faces))
    jmesh.spatial_sort_faces()
    c2ws = [nadir_camera(4.0, 50.0, PW),
            oblique_camera(4.0, 55.0, PW, pitch_deg=25.0, azimuth_deg=30.0)]
    c2ws[0][:3, 3] += (0.0123, -0.0217, 0.031)  # off the pixel grid
    sensors = {0: {"f": 50.0, "cx": 0.0, "cy": 0.0, "image_width": PW,
                   "image_height": PH}}
    jcams = JaxCameraSet(c2ws, sensors, sensor_IDs=[0, 0])
    hard = onehot_image(shape=(2, PH, PW), seed=1)
    hard[0, :5] = np.nan  # unlabeled rows
    soft = np.random.default_rng(2).random((2, PH, PW, C)).astype(np.float32)
    soft[1, 10:20, 10:20] = np.nan
    return jmesh, jcams, hard, soft


def project(mesh, cams, images, config, jax_side):
    """Every view's (sums, counts) as numpy, from either package."""
    if jax_side:
        seg_cams = JaxSegmentorCameraSet(cams, Images(images))
    else:
        seg_cams = SegmentorCameraSet(interop.cameras_from_jax(cams),
                                      Images(images))
        config = interop.raster_config_from_jax(config)
    return [tuple(np.asarray(t) for t in view)
            for view in mesh.project_images(seg_cams, config=config)]


def test_project_images_one_hot_takes_the_fused_path(scene, monkeypatch):
    """One-hot views: the port scans on the mesh's device, never calls the
    numpy scan, and yields (counts, total) equal to what the JAX package
    yields for the same views on its scatter path."""
    jmesh, jcams, hard, _ = scene
    mesh = interop.mesh_from_jax(jmesh, device="cpu")

    def refuse(img):
        raise AssertionError("project_images ran the host scan")

    monkeypatch.setattr(TexturedMesh, "_as_class_image", staticmethod(refuse))
    fused = []
    real = face_counts.face_class_counts_plain

    def spy(*args):
        fused.append(1)
        return real(*args)

    monkeypatch.setattr(face_counts, "face_class_counts_plain", spy)
    got = project(mesh, jcams, hard, XLA, jax_side=False)
    assert len(fused) == len(hard)
    ref = project(jmesh, jcams, hard, XLA, jax_side=True)
    for (sums, counts), (ref_sums, ref_counts) in zip(got, ref):
        assert sums.dtype == counts.dtype == np.float32
        np.testing.assert_array_equal(sums, ref_sums)
        np.testing.assert_array_equal(counts, ref_counts)
        assert sums.sum() > 1000
    # a float64 stack (the library's LookUpSegmentor emits float64) and a
    # uint8 stack equal their float32 twin
    for dtype in (np.float64, np.uint8):
        twin = project(mesh, jcams, np.nan_to_num(hard).astype(dtype), XLA,
                       jax_side=False)
        base = project(mesh, jcams, np.nan_to_num(hard), XLA, jax_side=False)
        for a, b in zip(twin, base):
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])


def test_project_images_soft_takes_the_means_path(scene, monkeypatch):
    """Soft views keep per-channel means: equal to the JAX package's to
    float32 rounding (rtol 1e-6: both sum the same float32 values per
    face, in different orders)."""
    jmesh, jcams, hard, soft = scene
    mesh = interop.mesh_from_jax(jmesh, device="cpu")

    def refuse(*args):
        raise AssertionError("a soft view reached the counts kernel")

    real = face_counts.face_class_counts_plain
    monkeypatch.setattr(face_counts, "face_class_counts_plain", refuse)
    got = project(mesh, jcams, soft, XLA, jax_side=False)
    # one spoiled pixel is enough to leave the fused path
    spoiled_view = hard.copy()
    spoiled_view[1, 30, 40] = [0, 0.5, 0.5, 0, 0]
    mixed = project(mesh, jcams.get_subset_cameras([1]), spoiled_view[1:], XLA,
                    jax_side=False)
    monkeypatch.setattr(face_counts, "face_class_counts_plain", real)
    ref = project(jmesh, jcams, soft, XLA, jax_side=True)
    for (sums, counts), (ref_sums, ref_counts) in zip(got, ref):
        np.testing.assert_allclose(sums, ref_sums, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(counts, ref_counts)
        assert counts.sum() > 1000
    ref_mixed = project(jmesh, jcams.get_subset_cameras([1]), spoiled_view[1:],
                        XLA, jax_side=True)
    np.testing.assert_allclose(mixed[0][0], ref_mixed[0][0], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(mixed[0][1], ref_mixed[0][1])
    # float64 soft values are cast on the device as the host cast them
    soft64 = project(mesh, jcams, soft.astype(np.float64), XLA, jax_side=False)
    for a, b in zip(soft64, got):
        np.testing.assert_array_equal(a[0], b[0])


def test_two_dimensional_images_skip_the_scan(scene, monkeypatch):
    """The shape gate stays on the host: an (H, W) image or a one-channel
    stack goes to the means path without the scan."""
    jmesh, jcams, _, soft = scene
    mesh = interop.mesh_from_jax(jmesh, device="cpu")

    def refuse(image):
        raise AssertionError("the scan ran on an image that is no stack")

    from geograypher_tpu_torch.meshes import mesh as mesh_module

    monkeypatch.setattr(mesh_module, "onehot_to_class", refuse)
    flat = project(mesh, jcams, soft[..., 0], XLA, jax_side=False)
    single = project(mesh, jcams, soft[..., :1], XLA, jax_side=False)
    ref = project(jmesh, jcams, soft[..., 0], XLA, jax_side=True)
    for a, b, r in zip(flat, single, ref):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_allclose(a[0], r[0], rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(a[1], r[1])
