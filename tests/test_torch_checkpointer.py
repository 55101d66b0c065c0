"""The port's CheckPointer: round trip, pointer, retention and an exact
resume, on the CPU (the JAX package's contract, tests/test_checkpoint.py).

The resume is held bit for bit: DLA-34 at 64x64, batch 2, Adamax with EMA,
four unbroken steps against two steps, a save, a restore into a fresh
state built from other weights, and two more steps. Parameters, BN
buffers, the optimizer state, the EMA shadow, ``step`` and ``updates``
must be equal, with no extra step after the restore: the schedule is a
function of ``updates``.
"""

import os

import numpy as np
import pytest
import torch
from torch import nn

from rtm3d_tpu_torch.config import default_config
from rtm3d_tpu_torch.nn.model import create_model
from rtm3d_tpu_torch.train.checkpoint import CheckPointer
from rtm3d_tpu_torch.train.state import TrainState
from rtm3d_tpu_torch.train.step import make_train_step
from rtm3d_tpu_torch.utils.measure import state_tensors, synthetic_labels, unequal



@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs test files side by side, and a
    DLA-34 step that takes every core of the machine slows all of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small_cfg():
    cfg = default_config()
    cfg.INPUT_SIZE = (64, 64)
    cfg.BATCH_SIZE = 2
    cfg.DATASET.MAX_OBJS = 6
    cfg.SOLVER.BASE_LR = 1e-3
    cfg.SOLVER.WARMUP_ITERS = 3
    cfg.TRAINING.EMA = True
    return cfg


def tiny_state(seed=0, with_ema=True):
    torch.manual_seed(seed)
    net = nn.Sequential(nn.Conv2d(3, 4, 3), nn.BatchNorm2d(4), nn.Conv2d(4, 2, 1))
    return TrainState.create(net, small_cfg(), device="cpu", with_ema=with_ema)


def test_round_trip_is_bit_equal(tmp_path):
    state = tiny_state()
    # optimizer state by hand: the tiny net is no RTM3D
    for p in state.model.parameters():
        p.grad = torch.randn_like(p)
    state.optimizer.step()
    state.step, state.updates = 7, 5
    with torch.no_grad():
        for v in state.ema.values():
            v.mul_(0.5)
    want = state_tensors(state)
    ck = CheckPointer(str(tmp_path))
    path = ck.save("model_0000003", state, epoch=3, min_loss=1.5)
    assert path.endswith("model_0000003.pt") and ck.get_checkpoint_file() == path
    fresh = tiny_state(seed=1)
    assert not torch.equal(fresh.model[0].weight, state.model[0].weight)
    got, meta = ck.load(fresh, use_latest=True)
    assert got is fresh and meta == {"epoch": 3, "min_loss": 1.5}
    assert not unequal(state_tensors(got), want)

    no_ema = tiny_state(seed=1, with_ema=False)
    with pytest.raises(ValueError, match="EMA"):
        ck.load(no_ema, path=path, use_latest=False)


def test_missing_checkpoint_returns_the_template(tmp_path):
    state = tiny_state()
    ck = CheckPointer(str(tmp_path / "none"))
    assert not ck.has_checkpoint() and ck.get_checkpoint_file() == ""
    got, meta = ck.load(state, use_latest=True)
    assert got is state and meta == {}
    got, meta = ck.load(state, path=str(tmp_path / "absent.pt"), use_latest=False)
    assert got is state and meta == {}


def test_retention_keeps_five_and_the_best(tmp_path):
    state = tiny_state()
    ck = CheckPointer(str(tmp_path))
    for epoch in range(8):
        ck.save(f"model_{epoch:07d}", state, epoch=epoch)
        if epoch in (1, 6):
            ck.save("model_best", state, epoch=epoch, min_loss=float(epoch))
    files = sorted(os.listdir(tmp_path))
    assert files == ["last_checkpoint", "model_0000003.pt", "model_0000004.pt", "model_0000005.pt",
                     "model_0000006.pt", "model_0000007.pt", "model_best.pt"]
    assert ck.get_checkpoint_file() == os.path.join(str(tmp_path), "model_0000007.pt")
    assert ck.load(tiny_state(), path=os.path.join(str(tmp_path), "model_best.pt"), use_latest=False)[1]["epoch"] == 6


def test_resume_is_bit_exact(tmp_path):
    cfg = small_cfg()
    rng = np.random.RandomState(4)
    batches = [{"image": torch.from_numpy(rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)),
                "labels": synthetic_labels(rng, 2, 6, scale=0.05)} for _ in range(4)]
    step = make_train_step(cfg, device="cpu")

    unbroken = TrainState.create(create_model(cfg, torch.Generator().manual_seed(0)), cfg, device="cpu")
    for b in batches:
        unbroken, _ = step(unbroken, b)

    first = TrainState.create(create_model(cfg, torch.Generator().manual_seed(0)), cfg, device="cpu")
    for b in batches[:2]:
        first, _ = step(first, b)
    saved = state_tensors(first)
    ck = CheckPointer(str(tmp_path))
    ck.save("model_0000000", first, epoch=0, min_loss=2.0)
    del first
    resumed = TrainState.create(create_model(cfg, torch.Generator().manual_seed(1)), cfg, device="cpu")
    resumed, meta = ck.load(resumed, use_latest=True)
    assert meta == {"epoch": 0, "min_loss": 2.0}
    assert not unequal(state_tensors(resumed), saved)  # before any step
    for b in batches[2:]:
        resumed, _ = step(resumed, b)
    assert resumed.step == unbroken.step == 4 and resumed.updates == unbroken.updates == 4
    assert not unequal(state_tensors(resumed), state_tensors(unbroken))
