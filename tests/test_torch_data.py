"""The port's KITTI reader, augmentation and generator against the JAX
package's, on the CPU.

One synthetic tree, written by the JAX generator (6 train and 3 test
frames of 64x192, up to 5 objects, Vans among them so that related-class
noise slots occur), is read by both packages. Both hold their pixels with
cv2 (the port through ``data/image_io.py``), so every comparison is exact:
images, labels, ``warp``, ``border``, ``photo``, ``image_idx`` and the
draws each sample takes from the shared ``RandomState``.
"""

import ast
import filecmp
import os
import shutil
from pathlib import Path

import cv2
import numpy as np
import pytest

from rtm3d_tpu.config import default_config as default_config_jax
from rtm3d_tpu.data import kitti as kitti_jax
from rtm3d_tpu.data.synthetic import generate_kitti as generate_kitti_jax
from rtm3d_tpu_torch.config import default_config
from rtm3d_tpu_torch.data import kitti
from rtm3d_tpu_torch.data.synthetic import generate_kitti

REPO = Path(__file__).resolve().parents[1]
TREE = dict(num_train=6, num_test=3, img_hw=(64, 192), max_objs=5)

# (name, config overrides, is_training): the reader's modes
MODES = [
    ("host_test", [], False),
    ("host_train", [], True),
    ("host_train_float", ["TPU.NORMALIZE_ON_DEVICE", "False"], True),
    ("raw_train", ["TPU.DEVICE_WARP", "True"], True),
    ("raw_test", ["TPU.DEVICE_WARP", "True"], False),
    ("cache_train", ["TPU.DEVICE_WARP", "True", "TPU.DEVICE_DATA_CACHE", "True"], True),
]


@pytest.fixture(scope="module")
def kitti_tree(tmp_path_factory):
    return generate_kitti_jax(str(tmp_path_factory.mktemp("kitti") / "kitti"), **TREE)


def configs(overrides=()):
    """The same small configuration in both packages: INPUT_SIZE 192 (rect
    192x64 on these frames), MAX_OBJS 8."""
    opts = ["INPUT_SIZE", "(192, 192)", "DATASET.MAX_OBJS", "8", *overrides]
    return default_config_jax().merge_from_list(list(opts)), default_config().merge_from_list(list(opts))


def datasets(root, overrides=(), is_training=True, split="train"):
    cj, cp = configs(overrides)
    return (kitti_jax.create_dataset(root, cj, is_training=is_training, split=split),
            kitti.create_dataset(root, cp, is_training=is_training, split=split))


def assert_same(a, b, where=""):
    """Equal structure, equal values, equal dtypes."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (str, list, int)):
        assert a == b, where
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=where)


@pytest.mark.parametrize("img_hw,n", [((64, 192), 9), ((375, 1242), 3)], ids=["64x192", "kitti_375x1242"])
def test_generator_writes_the_jax_tree(tmp_path, img_hw, n):
    a = generate_kitti_jax(str(tmp_path / "jax"), num_train=n - 2, num_test=2, img_hw=img_hw, max_objs=8)
    b = generate_kitti(str(tmp_path / "port"), num_train=n - 2, num_test=2, img_hw=img_hw, max_objs=8)
    for rel in ("ImageSets/train.txt", "ImageSets/test.txt"):
        assert filecmp.cmp(os.path.join(a, rel), os.path.join(b, rel), shallow=False)
    names = sorted(os.listdir(os.path.join(a, "training", "label_2")))
    assert len(names) == n
    for name in names:
        for sub in ("label_2", "calib"):
            assert filecmp.cmp(os.path.join(a, "training", sub, name), os.path.join(b, "training", sub, name),
                               shallow=False), (sub, name)
        png = name.replace(".txt", ".png")
        np.testing.assert_array_equal(cv2.imread(os.path.join(a, "training", "image_2", png)),
                                      cv2.imread(os.path.join(b, "training", "image_2", png)))


def test_parsers_match_jax(kitti_tree):
    names = sorted(os.listdir(os.path.join(kitti_tree, "training", "label_2")))
    seen = set()
    for name in names:
        lab = os.path.join(kitti_tree, "training", "label_2", name)
        cal = os.path.join(kitti_tree, "training", "calib", name)
        got, want = kitti.parse_label_file(lab), kitti_jax.parse_label_file(lab)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(kitti.parse_calib_file(cal), kitti_jax.parse_calib_file(cal))
        seen.update(got[:, 0].astype(int).tolist())
    assert {0, 1} <= seen  # Car and Van: a related class occurs


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_annotation_cache(kitti_tree, tmp_path, writer):
    root = str(tmp_path / "tree")
    shutil.copytree(kitti_tree, root, ignore=shutil.ignore_patterns("cache"))
    ds_jax, ds_port = None, None
    if writer == "jax":
        ds_jax = kitti_jax.create_dataset(root, configs()[0])
    else:
        ds_port = kitti.create_dataset(root, configs()[1])
    files = sorted(os.listdir(os.path.join(root, "cache")))
    assert files == ["k_train.npy", "label_train.npy", "shape_train.npy"]
    # the reader of the other package now finds the caches (the image
    # decode that builds the shapes no longer runs: break the images)
    for png in os.listdir(os.path.join(root, "training", "image_2")):
        os.remove(os.path.join(root, "training", "image_2", png))
    if writer == "jax":
        ds_port = kitti.create_dataset(root, configs()[1])
    else:
        ds_jax = kitti_jax.create_dataset(root, configs()[0])
    assert len(ds_port) == len(ds_jax) == TREE["num_train"]
    np.testing.assert_array_equal(ds_port._shapes, ds_jax._shapes)
    for a, b in zip(ds_port._labels, ds_jax._labels):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ds_port._K, ds_jax._K):
        np.testing.assert_array_equal(a, b)
    assert ds_port.img_size == ds_jax.img_size == [192, 64]


@pytest.mark.parametrize("mode", MODES, ids=[m[0] for m in MODES])
def test_samples_match_jax(kitti_tree, mode):
    name, overrides, is_training = mode
    split = "train" if is_training else "test"
    ds_jax, ds_port = datasets(kitti_tree, overrides, is_training, split)
    assert ds_port.img_size == ds_jax.img_size
    if ds_port.device_cache:
        assert_same(ds_jax.canvas_array(), ds_port.canvas_array(), "canvas")
    rng_jax, rng_port = np.random.RandomState(3), np.random.RandomState(3)
    noise_slots = 0
    for i in range(len(ds_jax)):
        want = ds_jax.__getitem__(i, rng=rng_jax)
        got = ds_port.__getitem__(i, rng=rng_port)
        assert_same(want, got, f"{name}[{i}]")
        noise_slots += int(got["labels"]["noise_mask"].sum())
        # the same draws, so the next sample's stream is the same
        assert rng_jax.randint(2**31 - 1) == rng_port.randint(2**31 - 1)
    # no rng: the per-index default seed
    assert_same(ds_jax[1], ds_port[1], f"{name}[1] default rng")
    if is_training:
        assert noise_slots > 0


def test_image_io_is_the_only_cv2_user():
    users = []
    for path in sorted((REPO / "rtm3d_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom) and node.module else [])
            if any(n.split(".")[0] == "cv2" for n in names):
                users.append(str(path.relative_to(REPO)))
    assert users == ["rtm3d_tpu_torch/data/image_io.py"]
