"""The port's fused host preprocessing (``data/native.py``,
``data/fast_preproc.py``, ``csrc/preproc.cc``) and mosaic
(``transforms.RandomAffine2D``, the reader's ``IS_MOSAIC`` mode) against the
JAX package's, on the CPU.

Tolerance of the fused warp: the JAX package builds ``native/preproc.cc``
with ``-march=native`` (native/Makefile), so its compiler contracts the
bilinear sums and the normalisation into FMAs; the port builds its copy
without it (``kernel_build.HOST_CXX_FLAGS``), and rounds each product. The
two outputs differ by a few float32 ulps: measured here at most 1.2e-6 on
values up to 2.64 (4.5e-7 relative). They are held within 1e-6 relative
plus 1e-6 absolute. The splat, the labels and the draws are exact; mosaic
goes through cv2 in both packages and is exact too.
"""

import numpy as np
import pytest

from rtm3d_tpu.data import fast_preproc as fast_preproc_jax
from rtm3d_tpu.data import native as native_jax
from rtm3d_tpu.data.transforms import RandomAffine2D as RandomAffine2DJax
from rtm3d_tpu_torch.data import fast_preproc, native
from rtm3d_tpu_torch.data.transforms import RandomAffine2D
from rtm3d_tpu_torch.utils import kernel_build
from tests.test_torch_data import assert_same, datasets, kitti_tree  # noqa: F401

MEAN, STD = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
RTOL = ATOL = 1e-6  # FMA contraction in the JAX build (module docstring)


@pytest.fixture(scope="module", autouse=True)
def jax_library():
    if not native_jax.available():
        pytest.skip("the JAX package's native library does not build here")


def assert_close_image(got, want, where=""):
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape, where
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=where)


def affines():
    """Forward 2x3 maps from a KITTI-sized frame: resize, resize + scale
    augmentation, mirrored, shifted partly outside, a shrink."""
    r = 1280 / 1242
    return {
        "resize": np.array([[r, 0, 0], [0, r, 15]]),
        "scale_aug": np.array([[r * 1.13, 0, -82.5], [0, r * 1.13, -10.2]]),
        "mirror": np.array([[-r, 0, 1280], [0, r, 15]]),
        "outside": np.array([[r, 0, 300.7], [0, r, -120.3]]),
        "shrink": np.array([[0.31, 0, 4.5], [0, 0.31, 2.25]]),
    }


def test_library_builds_into_the_port_build_dir():
    lib = kernel_build.host_library_path("preproc")
    native.load_library()
    assert lib.exists() and lib.parent == kernel_build.BUILD_DIR
    assert fast_preproc.available()


@pytest.mark.parametrize("name", sorted(affines()))
def test_warp_normalize_matches_jax(name):
    rng = np.random.RandomState(sorted(affines()).index(name))
    src = rng.randint(0, 256, (375, 1242, 3)).astype(np.uint8)
    M = affines()[name].astype(np.float32)
    border = rng.uniform(0, 255, 3).astype(np.float32)
    for b in (border, None):
        want = native_jax.warp_normalize(src, M, (416, 1280), MEAN, STD, border=b)
        got = native.warp_normalize(src, M, (416, 1280), MEAN, STD, border=b)
        assert_close_image(got, want, name)


def test_warp_normalize_batch_matches_jax():
    rng = np.random.RandomState(7)
    srcs = [rng.randint(0, 256, hw + (3,)).astype(np.uint8) for hw in ((375, 1242), (370, 1224), (64, 192))]
    Ms = np.stack([affines()[k] for k in ("resize", "mirror", "shrink")]).astype(np.float32)
    want = native_jax.warp_normalize_batch(srcs, Ms, (96, 320), MEAN, STD)
    got = native.warp_normalize_batch(srcs, Ms, (96, 320), MEAN, STD)
    assert_close_image(got, want)
    for i, (s, M) in enumerate(zip(srcs, Ms)):  # the batch is its images one by one
        np.testing.assert_array_equal(got[i], native.warp_normalize(s, M, (96, 320), MEAN, STD))


def test_splat_heatmap_matches_jax():
    rng = np.random.RandomState(3)
    n = 40
    centers = np.stack([rng.randint(-5, 85, n), rng.randint(-5, 37, n)], -1)
    noise, mask = rng.rand(n) < 0.2, rng.rand(n) < 0.8
    centers[:2] = [[10, 10], [60, 20]]  # a lone noise slot and a lone object slot
    noise[:2], mask[:2] = [True, False], True
    args = (centers, rng.randint(-1, 4, n), rng.uniform(0.5, 4, n), rng.randint(0, 8, n).astype(np.float32),
            noise, mask)
    want = native_jax.splat_heatmap(np.zeros((3, 32, 80), np.float32), *args)
    got = native.splat_heatmap(np.zeros((3, 32, 80), np.float32), *args)
    np.testing.assert_array_equal(got, want)
    assert (got == np.float32(0.9999)).any() and (got == 1.0).any()
    with pytest.raises(ValueError):
        native.splat_heatmap(np.zeros((3, 32, 80), np.float64), *args)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_fused_preproc_matches_jax(train):
    rng = np.random.RandomState(11)
    kw = dict(out_size=(1280, 416), resize_max_side=1280, mean=MEAN, std=STD, train=train)
    fj, fp = fast_preproc_jax.FusedPreproc(**kw), fast_preproc.FusedPreproc(**kw)
    rj, rp = np.random.RandomState(5), np.random.RandomState(5)
    mirrored = 0
    for i in range(6):
        img = rng.randint(0, 256, (375, 1242, 3)).astype(np.uint8)
        n = 4
        x1 = rng.uniform(0, 1100, n)
        y1 = rng.uniform(0, 300, n)
        labels = {"cls": np.zeros(n, np.int32), "bbox": np.stack([x1, y1, x1 + rng.uniform(1, 120, n),
                                                                   y1 + rng.uniform(1, 70, n)], -1).astype(np.float32),
                  "dim": rng.rand(n, 3).astype(np.float32), "alpha": rng.uniform(-3, 3, n).astype(np.float32),
                  "ry": rng.uniform(-3, 3, n).astype(np.float32), "loc": rng.randn(n, 3).astype(np.float32),
                  "K": np.tile(np.array([721.5, 0, 609.6, 0, 721.5, 172.9, 0, 0, 1], np.float32), (n, 1)),
                  "mask": np.ones(n, bool), "noise_mask": np.zeros(n, bool)}
        want_img, want = fj(img, {k: v.copy() for k, v in labels.items()}, rj)
        got_img, got = fp(img, {k: v.copy() for k, v in labels.items()}, rp)
        assert_close_image(got_img, want_img, f"image {i}")
        assert_same(want, got, f"labels {i}")
        mirrored += int(got["alpha"][0] != labels["alpha"][0])
        assert rj.randint(2**31 - 1) == rp.randint(2**31 - 1)
    assert mirrored > 0 if train else mirrored == 0


def assert_samples_match(ds_jax, ds_port, name, fused):
    rng_jax, rng_port = np.random.RandomState(3), np.random.RandomState(3)
    for i in range(len(ds_jax)):
        want = ds_jax.__getitem__(i, rng=rng_jax)
        got = ds_port.__getitem__(i, rng=rng_port)
        if fused:
            assert_close_image(got.pop("image"), want.pop("image"), f"{name}[{i}]")
        assert_same(want, got, f"{name}[{i}]")
        assert rng_jax.randint(2**31 - 1) == rng_port.randint(2**31 - 1)


@pytest.mark.parametrize("value", ["True", "auto"])
@pytest.mark.parametrize("is_training", [True, False], ids=["train", "test"])
def test_reader_fast_preproc_matches_jax(kitti_tree, value, is_training):
    ds_jax, ds_port = datasets(kitti_tree, ["DATASET.FAST_PREPROC", value], is_training,
                               "train" if is_training else "test")
    assert ds_port._fast is not None and ds_jax._fast is not None
    sample = ds_port[0]
    assert sample["image"].dtype == np.float32 and sample["image"].shape == (64, 192, 3)
    assert_samples_match(ds_jax, ds_port, f"fast_{value}", fused=True)


def test_reader_fast_preproc_gives_way_to_the_device_warp(kitti_tree):
    _, ds_port = datasets(kitti_tree, ["DATASET.FAST_PREPROC", "True", "TPU.DEVICE_WARP", "True"])
    assert "warp" in ds_port[0]


@pytest.mark.parametrize("overrides,is_training", [
    (["IS_MOSAIC", "True"], True),
    (["IS_MOSAIC", "True", "TPU.DEVICE_WARP", "True", "DATASET.FAST_PREPROC", "True"], True),
    (["IS_MOSAIC", "True", "TPU.NORMALIZE_ON_DEVICE", "False"], True),
    (["IS_MOSAIC", "True"], False),
], ids=["train", "train_over_warp_and_fast", "train_float", "test_host"])
def test_reader_mosaic_matches_jax(kitti_tree, overrides, is_training):
    ds_jax, ds_port = datasets(kitti_tree, overrides, is_training, "train" if is_training else "test")
    assert not ds_port.device_warp and ds_port._fast is None
    assert_samples_match(ds_jax, ds_port, "mosaic", fused=False)
    if is_training:
        # the mosaic frame is the padded size; masks drop what the homography cropped
        s = ds_port[0]
        assert s["image"].shape[:2] == (64, 192) and s["labels"]["mask"].dtype == bool


@pytest.mark.parametrize("params", [
    dict(),
    dict(degrees=10.0, translate=0.1, scale=0.5, shear=2.0),
    dict(degrees=0.0, translate=0.2, scale=0.3, shear=0.0, border=(-32, -96)),
], ids=["defaults", "rotate_shear", "border"])
def test_random_affine_2d_matches_jax(params):
    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (128, 384, 3)).astype(np.uint8)
    n = 6
    x1, y1 = rng.uniform(0, 300, n), rng.uniform(0, 100, n)
    labels = {"bbox": np.stack([x1, y1, x1 + rng.uniform(2, 80, n), y1 + rng.uniform(2, 40, n)], -1),
              "mask": np.ones(n, bool)}
    rj, rp = np.random.RandomState(9), np.random.RandomState(9)
    want_img, want = RandomAffine2DJax()(img, {k: v.copy() for k, v in labels.items()}, rng=rj, **params)
    got_img, got = RandomAffine2D()(img, {k: v.copy() for k, v in labels.items()}, rng=rp, **params)
    assert_same(want_img, got_img, "image")
    assert_same(want, got, "labels")
    assert rj.randint(2**31 - 1) == rp.randint(2**31 - 1)
