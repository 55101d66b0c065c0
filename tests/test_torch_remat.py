"""``TPU.REMAT`` in the port: the train step as checkpointed segments
(``nn/layers.py::remat_segment``), on the CPU.

- REMAT on against off, DLA-34 and ResNet-18 at 64x64, batch 2, MAX_OBJS
  6, one step with EMA, the network in float64 (the float32 gradient of
  this network carries about 1% of noise per tensor,
  tests/test_torch_train.py, and would hide a last-bit fault): the loss
  and aux, every gradient, the parameters and EMA after the Adamax
  update, every BN running mean and variance and
  ``num_batches_tracked``: bit-equal. The checkpoint keeps the forward's
  autograd graph and recomputes only the saved tensors, with the same
  operations on the same inputs, so nothing may differ at all.
- The witness: the same checkpoint without the BatchNorm guard
  (``_bn_guard`` replaced by ``torch.utils.checkpoint.noop_context_fn``)
  gives the same loss but counts every checkpointed BN twice and folds
  the batch into its running statistics twice: the guard is what holds
  the statistics.
- REMAT on against the JAX step under ``cfg.TPU.REMAT = True``
  (``jax.checkpoint`` of the forward, rtm3d_tpu/train/step.py:141-142) on
  the same weights and batch, both in float64, at
  tests/test_train_step.py's shapes and tests/test_torch_train.py's
  gates: loss and aux rel 1e-5, the BN statistics atol 1e-5, the
  parameters after one update at most 1e-3 of coordinates more than 1e-7
  apart and none more than 2e-6 + 1e-7 (tests/test_train_extras.py:102
  is the JAX package's own REMAT test).
- Two gloo ranks (this file run as a script, no JAX in the children, a
  ``file://`` rendezvous) with REMAT, through tests/test_torch_ddp.py's
  harness: in each rank REMAT on equals REMAT off bit for bit (the
  synchronised BatchNorm's shift is the running mean, which the first
  pass updates: a recompute that took it again would part in the last
  bits); a witness without the guard folds twice; and the two REMAT ranks
  against one rank without REMAT on the same global batch, at
  tests/test_torch_ddp.py's gates.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from rtm3d_tpu_torch.config import default_config
from rtm3d_tpu_torch.nn import layers
from rtm3d_tpu_torch.nn.model import create_model
from rtm3d_tpu_torch.train.state import TrainState
from rtm3d_tpu_torch.train.step import make_train_step

REPO = Path(__file__).resolve().parents[1]
B, N, HW = 2, 6, 64
KFNS = {"DLA-34": ["level2", "level3", "level4", "level5"], "RESNET-18": ["layer1", "layer2", "layer3", "layer4"]}


def remat_cfg(backbone="DLA-34", remat=False, batch=B):
    cfg = default_config()
    cfg.MODEL.BACKBONE = backbone
    cfg.MODEL.KFNs = KFNS[backbone]
    cfg.INPUT_SIZE = (HW, HW)
    cfg.BATCH_SIZE = batch
    cfg.DATASET.MAX_OBJS = N
    cfg.SOLVER.BASE_LR = 1e-3
    cfg.SOLVER.WARMUP_ITERS = 2
    cfg.TPU.DONATE = False
    cfg.TPU.S2D_STEM = False
    cfg.TPU.REMAT = remat
    return cfg


def f64_batch(seed, b=B):
    """A label block as tests/test_train_step.py makes it, one slot padded
    out and one flagged as noise, float64 frames."""
    from tests.test_torch_ddp import labels_batch

    rng = np.random.RandomState(seed)
    labels = labels_batch(rng, b)
    labels["mask"][0, N - 1] = False
    labels["noise_mask"][b - 1, 1] = True
    return {"image": rng.rand(b, HW, HW, 3), "labels": labels}


def float64_state(cfg, state_dict):
    model = create_model(cfg)
    model.load_state_dict(state_dict, strict=True)
    state = TrainState.create(model, cfg, device="cpu", with_ema=True)
    state.model.double()
    state.ema = {k: v.double() for k, v in state.ema.items()}
    return state


def run_steps(cfg, state_dict, batches) -> dict:
    """Steps on ``batches``: each step's loss items, step 1's gradients,
    then the parameters, EMA and every buffer."""
    state = float64_state(cfg, state_dict)
    step = make_train_step(cfg, device="cpu")
    out = {"loss_items": []}
    for i, b in enumerate(batches):
        state, m = step(state, b)
        out["loss_items"].append(m["loss_items"].clone())
        if i == 0:
            out["grads"] = {k: None if p.grad is None else p.grad.clone() for k, p in state.model.named_parameters()}
    out["params"] = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    out["ema"] = {k: v.clone() for k, v in state.ema.items()}
    out["buffers"] = {k: v.clone() for k, v in state.model.named_buffers()}
    return out


def unguarded():
    """The checkpoint without the BatchNorm guard: a plain
    ``torch.utils.checkpoint`` recompute."""
    saved = layers._bn_guard
    layers._bn_guard = lambda module: torch.utils.checkpoint.noop_context_fn()
    return saved


def equal_runs(a: dict, b: dict) -> list:
    """The names of what differs between two ``run_steps`` records."""
    bad = [f"loss_items[{i}]" for i, (x, y) in enumerate(zip(a["loss_items"], b["loss_items"])) if not torch.equal(x, y)]
    for key in ("grads", "params", "ema", "buffers"):
        for k, x in a[key].items():
            y = b[key][k]
            if (x is None) != (y is None) or (x is not None and not torch.equal(x, y)):
                bad.append(f"{key}:{k}")
    return bad


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    """Each backbone's seed-0 weights with random BN statistics, one step:
    REMAT off, on, and on without the guard."""
    batches = [f64_batch(5)]
    out = {}
    for backbone in KFNS:
        model = create_model(remat_cfg(backbone))
        gen = torch.Generator().manual_seed(3)
        with torch.no_grad():
            for k, v in model.named_buffers():
                if k.endswith("running_mean"):
                    v.normal_(0, 0.02, generator=gen)
                elif k.endswith("running_var"):
                    v.uniform_(0.9, 1.1, generator=gen)
        sd = model.state_dict()
        rec = {remat: run_steps(remat_cfg(backbone, remat), sd, batches) for remat in (False, True)}
        saved = unguarded()
        try:
            rec["unguarded"] = run_steps(remat_cfg(backbone, True), sd, batches)
        finally:
            layers._bn_guard = saved
        out[backbone] = rec
    return out


@pytest.mark.parametrize("backbone", list(KFNS))
def test_remat_equals_no_remat_bit_for_bit(runs, backbone):
    off, on = runs[backbone][False], runs[backbone][True]
    assert equal_runs(on, off) == []
    tracked = {k: int(v) for k, v in on["buffers"].items() if k.endswith("num_batches_tracked")}
    assert tracked and set(tracked.values()) == {1}  # each BN counted once in the step


@pytest.mark.parametrize("backbone", list(KFNS))
def test_unguarded_checkpoint_folds_the_statistics_twice(runs, backbone):
    one, bad = runs[backbone][False], runs[backbone]["unguarded"]
    assert torch.equal(bad["loss_items"][0], one["loss_items"][0])  # the forward's output is the same
    tracked = {k[:-len("num_batches_tracked")]: int(v) for k, v in bad["buffers"].items()
               if k.endswith("num_batches_tracked")}
    twice = {p for p, n in tracked.items() if n == 2}
    # every BN of a checkpointed segment counts the step twice; ResNet's
    # stem (no segment) once
    assert set(tracked.values()) == ({2} if backbone == "DLA-34" else {1, 2})
    assert "detect_header.main_kf_header.1." in twice and "kfpn_fusion." not in tracked
    for p in twice:
        assert not torch.equal(bad["buffers"][p + "running_mean"], one["buffers"][p + "running_mean"]), p
        assert not torch.equal(bad["buffers"][p + "running_var"], one["buffers"][p + "running_var"]), p
    for p in set(tracked) - twice:
        assert torch.equal(bad["buffers"][p + "running_mean"], one["buffers"][p + "running_mean"]), p


def test_remat_step_matches_the_jax_remat_step():
    """One train step, REMAT on in both packages, float64 on both sides,
    the JAX weights (BN statistics drawn at random) carried across."""
    import jax
    import jax.numpy as jnp

    from rtm3d_tpu.train import optim as optim_jax
    from rtm3d_tpu.train.state import TrainState as TrainStateJax
    from rtm3d_tpu.train.step import make_train_step as make_train_step_jax
    from rtm3d_tpu_torch.train.checkpoint import state_dict_from_jax
    from tests.test_torch_model import jax_variables
    from tests.test_torch_train import make_batch, train_cfg

    cfg = train_cfg()
    cfg.TPU.REMAT = True
    jax_model, variables = jax_variables(cfg, seed=2)
    batch = make_batch(5)
    to64 = lambda tree: jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64) if a.dtype == np.float32 else jnp.asarray(a), tree)
    with jax.enable_x64():
        v64 = to64(variables)
        tx, _ = optim_jax.build_optimizer(cfg, v64["params"])
        want_state, want = make_train_step_jax(jax_model, cfg, tx)(TrainStateJax.create(v64, tx, with_ema=True),
                                                                    to64(batch))
        want_state, want = jax.device_get(want_state), jax.device_get(want)

    port_cfg = remat_cfg(remat=True)  # the same solver and shapes as train_cfg's
    model = create_model(port_cfg)
    state = float64_state(port_cfg, state_dict_from_jax(variables, model))
    state, got = make_train_step(port_cfg, device="cpu")(state, dict(batch, image=batch["image"].astype(np.float64)))
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["loss_items"].numpy(), want["loss_items"], rtol=1e-5)
    sd = state_dict_from_jax({"params": want_state.params, "batch_stats": want_state.batch_stats}, state.model)
    for k, buf in state.model.named_buffers():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), sd[k].numpy(), atol=1e-5, rtol=0, err_msg=k)
    diff = np.concatenate([np.abs(p.detach().numpy() - sd[k].numpy()).ravel()
                           for k, p in state.model.named_parameters()])
    assert (diff > 1e-7).mean() <= 1e-3 and diff.max() <= 2e-6 + 1e-7, ((diff > 1e-7).mean(), diff.max())


# --- two gloo ranks -------------------------------------------------------

WORLD = 2


def _rank_main(workdir: str, rank: int) -> None:
    """One rank: REMAT off, on, and on without the guard, on this rank's
    rows of the same global batches."""
    from rtm3d_tpu_torch.parallel import dist
    from tests.test_torch_ddp import rows

    torch.set_num_threads(2)
    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    dist.init_distributed("cpu", init_method=f"file://{workdir}/store", rank=rank, world_size=WORLD, timeout=60)
    try:
        mine = [rows(b, rank) for b in inputs["batches"]]
        sd = inputs["state_dict"]
        off = run_steps(remat_cfg(remat=False, batch=B * WORLD), sd, mine)
        on = run_steps(remat_cfg(remat=True, batch=B * WORLD), sd, mine)
        saved = unguarded()
        try:
            bad = run_steps(remat_cfg(remat=True, batch=B * WORLD), sd, mine)
        finally:
            layers._bn_guard = saved
        out = {"on_equals_off": equal_runs(on, off), "on": on if rank == 0 else None,
               "unguarded_tracked": sorted({int(v) for k, v in bad["buffers"].items()
                                            if k.endswith("num_batches_tracked")}),
               "digest": [float(p.sum()) for p in on["params"].values()]}
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.shutdown()


def test_two_remat_ranks_equal_one_rank_without_remat(tmp_path):
    from tests.test_torch_ddp import (BUFFER_ATOL, GRAD_L2, GRAD_L2_TENSOR, LOSS_REL, PARAM_ATOL, TIMEOUT_S,
                                      train_batch, wait_all)

    batches = [train_batch(5)]  # 11 objects on rank 0's rows, 3 on rank 1's
    batches = [dict(b, image=b["image"].astype(np.float64)) for b in batches]
    sd = create_model(remat_cfg()).state_dict()
    torch.save({"batches": batches, "state_dict": sd}, tmp_path / "inputs.pt")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]),
               OMP_NUM_THREADS="2")
    procs = []
    for r in range(WORLD):
        with open(tmp_path / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen([sys.executable, __file__, str(tmp_path), str(r)], cwd=REPO, env=env,
                                          stdout=log, stderr=subprocess.STDOUT))
    wait_all(procs, TIMEOUT_S)
    for r, p in enumerate(procs):
        assert p.returncode == 0, (tmp_path / f"rank{r}.log").read_text()[-4000:]
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    for f in ["inputs.pt"] + [f"rank{r}.pt" for r in range(WORLD)]:  # half a GB the suite need not keep
        (tmp_path / f).unlink()

    for r in ranks:
        assert r["on_equals_off"] == []  # in each rank, bit for bit
        assert r["unguarded_tracked"] == [2]  # the witness counts every BN twice
    assert ranks[0]["digest"] == ranks[1]["digest"]
    one = run_steps(remat_cfg(remat=False, batch=B * WORLD), sd, batches)
    on = ranks[0]["on"]
    for got, want in zip(on["loss_items"], one["loss_items"]):
        torch.testing.assert_close(got, want, rtol=LOSS_REL, atol=0)
    names = [k for k, g in one["grads"].items() if g is not None and g.norm() > 0]
    flat = lambda d: torch.cat([d[k].reshape(-1) for k in names])
    assert float((flat(on["grads"]) - flat(one["grads"])).norm() / flat(one["grads"]).norm()) <= GRAD_L2
    for k in names:
        assert float((on["grads"][k] - one["grads"][k]).norm() / one["grads"][k].norm()) <= GRAD_L2_TENSOR, k
    for key, atol in (("params", PARAM_ATOL), ("ema", PARAM_ATOL)):
        for k, v in one[key].items():
            assert float((on[key][k] - v).abs().max()) <= atol, (key, k)
    for k, v in one["buffers"].items():
        if k.endswith(("running_mean", "running_var")):
            assert float((on["buffers"][k] - v).abs().max()) <= BUFFER_ATOL, k


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
