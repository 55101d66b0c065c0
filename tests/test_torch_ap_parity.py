"""The production same-weights campaign of the port
(``rtm3d_tpu_torch/tools/ap_parity.py``) against the JAX tool's production
mode (``tools/ap_parity.py``), on the CPU.

- ``make_config`` equals the JAX tool's on every key the port has, for
  both backbones.
- ``fixture`` writes the JAX ``_fixture``'s label, calib and split files
  byte for byte for the same seed and size.
- ``step_stream`` yields the JAX ``_step_stream``'s frames in its order,
  over two epochs and from a resume step, each package's loader on the
  same tree.
- A small campaign (input 128, so 128x96 frames and input; 8 train and 4
  test frames; 20 steps at b4; ResNet-18): the loss falls, the report has
  the JAX keys with the port's leg names, a second call does not retrain,
  and every cell's |delta| is within tests/test_ap_parity.py:89's bound of
  5 points; the frames are made at the input's size, so the legs' boxes
  in the original frame are those in the input frame.
- The campaign's training batches (the cached, uint8, test-transform
  stream) equal the JAX tool's, pixels and labels, and the serving legs'
  host-normalised pixels equal the training's normalised on the device.
- The port's seed-20 init has the JAX ``init_model`` draw's scale: every
  tensor's standard deviation within 10% (those of more than 16 values).
- A run cut after 3 of 6 steps (input 64, b2) resumes from its mid
  checkpoint (saved at step 2) to the losses of an uninterrupted run, bit
  for bit.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from rtm3d_tpu.data import transforms as transforms_jax
from rtm3d_tpu.data.kitti import create_dataset as create_dataset_jax
from rtm3d_tpu.data.loader import DataLoader as DataLoaderJax
from rtm3d_tpu.nn.model import init_model
from rtm3d_tpu_torch.cli.detect import original_frame_boxes
from rtm3d_tpu_torch.data import transforms
from rtm3d_tpu_torch.data.kitti import create_dataset
from rtm3d_tpu_torch.data.loader import DataLoader
from rtm3d_tpu_torch.nn.model import create_model
from rtm3d_tpu_torch.tools import ap_parity
from rtm3d_tpu_torch.train.checkpoint import state_dict_from_jax
from rtm3d_tpu_torch.train.step import normalize_images
from tools import ap_parity as ap_jax

SMALL = dict(input_size=128, num_train=8, num_test=4, steps=20, batch=4, save_every=10, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def flat(cfg, prefix=""):
    out = {}
    for k, v in cfg.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = tuple(v) if isinstance(v, list) else v
    return out


@pytest.mark.parametrize("backbone", ap_parity.BACKBONES)
def test_make_config_equals_the_jax_tools(backbone):
    got = flat(ap_parity.make_config("/data", 512, 8, 1e-3, backbone))
    want = flat(ap_jax.make_config("/data", 512, 8, 1e-3, backbone))
    assert len(got) > 80 and set(got) <= set(want), set(got) - set(want)
    assert {k: v for k, v in got.items() if v != want[k]} == {}
    assert (got["DATASET.MAX_OBJS"], got["DETECTOR.SCORE_THRESH"], got["DETECTOR.TOPK_CANDIDATES"]) == (8, 0.25, 20)


def test_fixture_writes_the_jax_fixtures_files(tmp_path):
    port = ap_parity.fixture(str(tmp_path / "port"), 128, 4, 3, seed=20)
    jax = ap_jax._fixture(str(tmp_path / "jax"), 128, 4, 3, seed=20)
    names = 0
    for sub in ("training/label_2", "training/calib", "ImageSets"):
        files = sorted(os.listdir(os.path.join(jax, sub)))
        assert files == sorted(os.listdir(os.path.join(port, sub))) and files
        for f in files:
            names += 1
            with open(os.path.join(jax, sub, f), "rb") as a, open(os.path.join(port, sub, f), "rb") as b:
                assert a.read() == b.read(), (sub, f)
    assert names == 7 + 7 + 2  # ImageSets: train.txt, test.txt


def test_step_stream_replays_the_jax_stream(tmp_path):
    data = ap_parity.fixture(str(tmp_path), 128, 6, 1, seed=20)
    cfg, cfg_jax = ap_parity.make_config(data, 128, 2, 1e-3), ap_jax.make_config(data, 128, 2, 1e-3)
    ds = create_dataset(data, cfg, is_training=True, split="train", augment=transforms.test_transform(128))
    ds_jax = create_dataset_jax(data, cfg_jax, is_training=True, split="train",
                                augment=transforms_jax.test_transform(128))
    loader = DataLoader(ds, 2, shuffle=True, seed=20, num_shards=1, shard_index=0)
    loader_jax = DataLoaderJax(ds_jax, 2, shuffle=True, seed=20, num_shards=1, shard_index=0)
    assert len(loader) == len(loader_jax) == 3
    for start in (0, 4):
        got = [(si, list(b["path"])) for si, b in ap_parity.step_stream(loader, 7, start)]
        want = [(si, list(b["path"])) for si, b in ap_jax._step_stream(loader_jax, 7, start)]
        assert got == want and len(got) == 7 - start
    epochs = [p for _, b in ap_parity.step_stream(loader, 6, 0) for p in b["path"]]
    assert sorted(epochs[:6]) == sorted(epochs[6:]) and epochs[:6] != epochs[6:]  # two shuffled epochs


def test_training_batches_are_the_jax_tools(tmp_path):
    data = ap_parity.fixture(str(tmp_path), 128, 6, 1, seed=20)
    cfgs = ap_parity.make_config(data, 128, 3, 1e-3), ap_jax.make_config(data, 128, 3, 1e-3)
    for c in cfgs:
        c.DATASET.CACHE_IMAGES, c.TPU.NORMALIZE_ON_DEVICE = True, True
    ds = create_dataset(data, cfgs[0], is_training=True, split="train", augment=transforms.test_transform(128))
    ds_jax = create_dataset_jax(data, cfgs[1], is_training=True, split="train",
                                augment=transforms_jax.test_transform(128))
    got = [b for _, b in ap_parity.step_stream(DataLoader(ds, 3, shuffle=True, seed=20), 3, 0)]
    want = [b for _, b in ap_jax._step_stream(DataLoaderJax(ds_jax, 3, shuffle=True, seed=20, num_shards=1,
                                                            shard_index=0), 3, 0)]
    for b, w in zip(got, want):
        assert b["image"].dtype == np.uint8 and np.array_equal(b["image"], w["image"])
        assert b["labels"].keys() == w["labels"].keys()
        for k in w["labels"]:
            np.testing.assert_array_equal(np.asarray(b["labels"][k]), np.asarray(w["labels"][k]), err_msg=k)
    serve_cfg = ap_parity.make_config(data, 128, 3, 1e-3)
    serve = create_dataset(data, serve_cfg, is_training=False, split="train")
    by_path = {serve[i]["path"]: serve[i]["image"] for i in range(len(serve))}
    normed = normalize_images(torch.from_numpy(np.asarray(got[0]["image"])), cfgs[0]).numpy()
    for i, path in enumerate(got[0]["path"]):
        np.testing.assert_array_equal(normed[i], by_path[path])


def test_init_draw_has_the_jax_scale():
    cfg_jax = ap_jax.make_config("/data", 128, 8, 1e-3)
    _, variables = init_model(cfg_jax, jax.random.PRNGKey(20), input_size=(128, 96))
    model = create_model(ap_parity.make_config("/data", 128, 8, 1e-3), torch.Generator().manual_seed(20))
    want = state_dict_from_jax(jax.device_get(variables), model)
    checked = 0
    for k, v in model.state_dict().items():
        if v.numel() > 16 and v.is_floating_point() and want[k].std() > 0:
            checked += 1
            assert abs(v.std().item() / want[k].std().item() - 1) < 0.1, k
    assert checked > 50  # the convs; BN starts at constants


def test_production_parity_small(tmp_path, monkeypatch):
    out = ap_parity.run_production_parity(str(tmp_path), progress=lambda *a: None, **SMALL)
    assert {"config", "loss_first_last", "accepted_counts", "ap", "legs", "train"} <= set(out)
    assert out["config"]["mode"] == "production_same_weights" and out["config"]["input"] == [128, 96]
    assert out["train"]["steps_run"] == 20 and out["train"]["splat_launches"] == 0  # the CPU's plain splat
    l0, l1 = out["loss_first_last"]
    assert l1 < l0
    assert set(out["accepted_counts"]) == set(out["legs"]) == {"port", "torch", "int8"}
    assert len(out["ap"]) == 27
    for key, row in out["ap"].items():
        assert set(row) == {"port", "torch", "delta", "int8", "delta_int8"}
        assert abs(row["delta"]) <= 5.0, (key, row)
    for leg in ("port", "torch", "int8"):
        assert len(os.listdir(tmp_path / f"results_{leg}")) == 4

    # the frames are the input's size: the original frame is the input frame
    cfg = ap_parity.make_config(str(tmp_path / "kitti"), 128, 4, 1e-3)
    ds = create_dataset(cfg.DATASET.PATH, cfg, is_training=False, split="test")
    boxes = np.random.RandomState(0).uniform(0, 95, (5, 4)).astype(np.float32)
    for i in range(len(ds)):
        shape = ds[i]["shape"]
        assert list(shape) == ds.img_size == [128, 96]
        np.testing.assert_array_equal(original_frame_boxes(boxes, shape, ds.resize_max_side, ds.img_size), boxes)

    # a second call serves the saved weights and does not train
    monkeypatch.setattr(ap_parity, "make_train_step", None)
    again = ap_parity.run_production_parity(str(tmp_path), progress=lambda *a: None, **SMALL)
    assert again["loss_first_last"] == out["loss_first_last"] and again["train"] == {"steps_run": 0}
    assert again["accepted_counts"] == out["accepted_counts"] and again["ap"] == out["ap"]


def train_args(tmp_path, name):
    data = ap_parity.fixture(str(tmp_path / name), 64, 4, 1, seed=20)
    cfg = ap_parity.make_config(data, 64, 2, 1e-3)
    cfg.DATASET.CACHE_IMAGES, cfg.TPU.NORMALIZE_ON_DEVICE = True, True
    ds = create_dataset(data, cfg, is_training=True, split="train")
    cfg.INPUT_SIZE = tuple(ds.img_size)
    return cfg, ds, str(tmp_path / name)


def test_mid_checkpoint_resume_gives_the_uninterrupted_losses(tmp_path, monkeypatch):
    kw = dict(steps=6, batch=2, seed=20, resume=True, save_every=2, device=torch.device("cpu"),
              progress=lambda *a: None)
    _, whole, rec = ap_parity.train_port(*train_args(tmp_path, "whole"), **kw)
    assert rec["steps_run"] == 6 and len(whole) == 6 and whole[-1] < whole[0]

    make = ap_parity.make_train_step

    def cut_after_3(cfg, device=None):
        step, calls = make(cfg, device=device), []

        def train_step(state, batch, cache=None):
            calls.append(1)
            if len(calls) > 3:
                raise RuntimeError("cut")
            return step(state, batch, cache)

        return train_step

    args = train_args(tmp_path, "cut")
    monkeypatch.setattr(ap_parity, "make_train_step", cut_after_3)
    with pytest.raises(RuntimeError, match="cut"):
        ap_parity.train_port(*args, **kw)
    assert os.path.exists(os.path.join(args[2], "train_ckpt.pt"))
    assert not os.path.exists(os.path.join(args[2], "port_final.pt"))
    monkeypatch.setattr(ap_parity, "make_train_step", make)
    model, resumed, rec = ap_parity.train_port(*args, **kw)
    assert rec["first_step"] == 2 and rec["steps_run"] == 4
    assert resumed == whole
    with open(os.path.join(args[2], "losses.json")) as f:
        assert json.load(f)["port"] == whole
