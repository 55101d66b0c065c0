"""``python -m rtm3d_tpu_torch.cli.train`` on the CPU, from the KITTI tree of
tests/test_torch_data.py, and one train step from files against the JAX
package's.

The CLI: DLA-34 at INPUT_SIZE (192, 192), rect 192x64 on these frames,
batch 2, under both DLA-34 configs (host resampling; device warp + device
cache), 2 epochs, then a resume to 3: the checkpoints and the pointer are
written, the resume starts at epoch 2 with the state the first run ended
with, bit for bit, and leaves the pointer on its last save.

One step from files: one loader batch (raw mode with the device cache,
the photometric std set to 0 so that both sides are deterministic) goes
through the JAX ``make_train_step`` with its ``image_cache`` and the
port's, from the same weights (``state_dict_from_jax``), the JAX side in
float64 as in tests/test_torch_train.py. The port's float32 step: loss
within that file's rel 1e-5; aux within rel 1e-5 or 1e-4 absolute, for
the offset terms of about 0.14 carry the float32 noise of the network,
which moves with the thread count (measured 3.5e-6 at 8 threads, 3.0e-5
at 2). The same loss with the port's network in float64, on the step's
own warped input: aux within rel 1e-5 with no absolute floor (measured
5.3e-6, on the vertex-offset term: the input warp and the targets are
float32 on both sides).
"""

import math
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtm3d_tpu.config import load_config as load_config_jax
from rtm3d_tpu.train import optim as optim_jax
from rtm3d_tpu.train.state import TrainState as TrainStateJax
from rtm3d_tpu.train.step import make_train_step as make_train_step_jax
from rtm3d_tpu_torch.cli import train as cli
from rtm3d_tpu_torch.config import load_config
from rtm3d_tpu_torch.data.kitti import create_dataset
from rtm3d_tpu_torch.data.loader import DataLoader
from rtm3d_tpu_torch.nn.model import create_model
from rtm3d_tpu_torch.train.checkpoint import state_dict_from_jax
from rtm3d_tpu_torch.train.state import TrainState
from rtm3d_tpu_torch.train.step import _loss_from_batch, _to_device, make_train_step, prepare_images
from rtm3d_tpu_torch.utils.measure import state_tensors, unequal
from tests.test_torch_data import REPO, kitti_tree  # noqa: F401
from tests.test_torch_model import jax_variables

CONFIGS = ["rtm3d_dla34_kitti.yaml", "rtm3d_dla34_kitti_tpu.yaml"]
SMALL = ["INPUT_SIZE", "(192, 192)", "BATCH_SIZE", "2", "DATASET.MAX_OBJS", "8", "num_workers", "2",
         "TRAINING.LOGDIR", "''"]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs test files side by side, and a
    DLA-34 step that takes every core of the machine slows all of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(config, tree, weights, mode, epochs, on_start=None):
    return cli.main(["--model-config", str(REPO / "configs" / config), "--data-path", tree, "--device", "cpu",
                     "--set", *SMALL, "TRAINING.WEIGHTS", weights, "TRAINING.CHECKPOINT_MODE", mode,
                     "SOLVER.MAX_EPOCH", str(epochs)], on_start=on_start)


@pytest.mark.parametrize("config", CONFIGS)
def test_cli_trains_checkpoints_and_resumes(kitti_tree, tmp_path, config):  # noqa: F811
    weights = str(tmp_path / "weights")
    try:
        first = run(config, kitti_tree, weights, "start", 2)
        assert first["img_size"] == [192, 64] and first["start_epoch"] == 0
        hist = first["history"]
        assert [h["epoch"] for h in hist] == [0, 1] and all(h["steps"] == 3 for h in hist)
        assert all(math.isfinite(v) for h in hist for v in h["train_loss"] + h["eval_loss"])
        assert all(len(h["build_s"]) == 3 for h in hist) and hist[0]["step_span_ms"] is None
        tpu = config.endswith("_tpu.yaml")
        assert (first["cache_bytes"] > 0) == tpu
        assert (first["state"].ema is not None) == tpu
        save_dir = os.path.join(weights, "DLA-34")
        files = sorted(os.listdir(save_dir))
        assert files[:3] == ["last_checkpoint", "model_0000000.pt", "model_0000001.pt"] and "model_best.pt" in files
        last = open(os.path.join(save_dir, "last_checkpoint")).read()
        assert os.path.basename(last) in ("model_0000001.pt", "model_best.pt")
        ended = state_tensors(first["state"])
        del first

        seen = {}

        def on_start(state, start_epoch):
            seen["epoch"] = start_epoch
            assert not unequal(state_tensors(state), ended)

        second = run(config, kitti_tree, weights, "resume", 3, on_start=on_start)
        assert seen["epoch"] == 2 and second["start_epoch"] == 2
        assert [h["epoch"] for h in second["history"]] == [2]
        assert second["state"].step == 9 and second["state"].updates == 9
        last = open(os.path.join(save_dir, "last_checkpoint")).read()
        best = second["history"][0]["eval_loss"][-1] < min(h["eval_loss"][-1] for h in hist)
        assert os.path.basename(last) == ("model_best.pt" if best else "model_0000002.pt")
        assert "model_best.pt" in os.listdir(save_dir)
    finally:
        shutil.rmtree(weights, ignore_errors=True)


def test_pretrained_needs_a_pt_file(kitti_tree, tmp_path):  # noqa: F811
    with pytest.raises(ValueError, match=r"\.pt"):
        cli.main(["--model-config", str(REPO / "configs" / CONFIGS[0]), "--data-path", kitti_tree,
                  "--device", "cpu", "--set", *SMALL, "TRAINING.WEIGHTS", str(tmp_path),
                  "TRAINING.CHECKPOINT_MODE", "pretrained", "TRAINING.CHECKPOINT_FILE", "w.msgpack"])


def test_one_step_from_files_matches_jax(kitti_tree):  # noqa: F811
    opts = [*SMALL, "TPU.COMPUTE_DTYPE", "float32", "TPU.S2D_STEM", "False", "TPU.DONATE", "False",
            "SOLVER.WARMUP_ITERS", "2"]
    cfg = load_config(str(REPO / "configs" / CONFIGS[1]), opts)
    cfg_jax = load_config_jax(str(REPO / "configs" / CONFIGS[1]), opts)
    ds = create_dataset(kitti_tree, cfg, is_training=True, split="train")
    assert ds.device_cache and ds.img_size == [192, 64]
    cfg.INPUT_SIZE = cfg_jax.INPUT_SIZE = tuple(ds.img_size)
    cache = ds.canvas_array()
    batch = next(iter(DataLoader(ds, 2, seed=20)))
    batch["photo"][:, 2] = 0.0  # no noise: both sides deterministic
    assert (batch["photo"][:, :2] != [1.0, 0.0]).any() or (batch["warp"][:, 0] < 0).any()
    arrays = {k: v for k, v in batch.items() if k not in ("path", "num_valid")}

    jax_model, variables = jax_variables(cfg_jax, seed=3)
    with jax.enable_x64():
        f64 = lambda tree: jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64) if a.dtype == np.float32 else jnp.asarray(a), tree)
        v64 = f64(variables)
        tx, _ = optim_jax.build_optimizer(cfg_jax, v64["params"])
        state_jax = TrainStateJax.create(v64, tx, with_ema=True)
        _, want = make_train_step_jax(jax_model, cfg_jax, tx)(state_jax, jax.tree_util.tree_map(jnp.asarray, arrays),
                                                              jnp.asarray(cache))
        want = jax.device_get(want)

    model = create_model(cfg)
    model.load_state_dict(state_dict_from_jax(variables, model), strict=True)
    state = TrainState.create(model, cfg, device="cpu")
    state, got = make_train_step(cfg, device="cpu")(state, batch, torch.from_numpy(cache))
    assert state.step == 1 and state.ema is not None
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["loss_items"].numpy(), want["loss_items"], rtol=1e-5, atol=1e-4)
    assert int(got["num_targets"]) == int(want["num_targets"]) > 0

    b = _to_device(batch, torch.device("cpu"))
    x = prepare_images(b, cfg, torch.from_numpy(cache)).double()
    net = create_model(cfg).double().train()
    net.load_state_dict(state_dict_from_jax(variables, net), strict=True)
    _, aux64 = _loss_from_batch(net, cfg, {"image": x, "labels": b["labels"]})
    np.testing.assert_allclose(aux64.numpy(), want["loss_items"], rtol=1e-5)
