"""Data-parallel training of the port (``parallel/dist.py``): two gloo ranks
on the CPU against one rank on the same global batch, and against the
JAX package's single-device step on it.

One launch of two processes (this file run as a script, ``_rank_main``:
no JAX in the children, two intra-op threads each, a ``file://``
rendezvous in the test's directory, every wait bounded) runs every case
below over one process group and writes what it saw; the one-rank runs
and the JAX step run here, in the test process. Each rank holds the
contiguous half of every global batch.

- Synchronised BatchNorm: each rank half of a (4, 5, 3, 3) batch (mean
  1, spread 3) against the port's ``BatchNorm`` on all of it. Output,
  input gradient, the weight and bias gradients summed over the ranks,
  the biased running mean and variance: within 1e-6 of the largest
  value (measured 1.1e-7).
- Losses: ``rtm3d_loss`` on random logits over ``build_targets`` of a
  batch whose two halves hold 11 and 3 objects, of one whose objects all
  sit on rank 0, and of one with no positive on any rank (the focal
  term's ``num_pos == 0`` branch). The global-batch values on every rank
  against one rank's on the whole batch: rel 1e-6 (measured 0); the
  gradient of the global loss in the logits, the mean of the ranks'
  (each rank's share's gradient over the world size): rel 1e-6 of the
  largest (measured 8.9e-8).
- Train step: DLA-34 at 64x64, MAX_OBJS 6, global batch 4 whose two
  halves hold 11 and 3 objects, three steps with EMA from the JAX
  initial weights (``state_dict_from_jax``), BASE_LR 1e-3 with 2 warm-up
  steps, the network in float64 (the loss is float32 in every run): the
  float32 gradient of this network carries about 1% of noise per tensor
  (tests/test_torch_train.py), which would hide what the collectives do.
  Against one rank on the same batches: the loss and aux of each step
  rel 1e-6 (measured 1.1e-7), the BN running statistics atol 1e-7
  (measured 5.4e-9), the step-1 gradient (what the all-reduce applied)
  rel 1e-8 in L2 over all of it and 1e-6 per tensor (measured 2.0e-10
  and 3.1e-8), the parameters and the EMA after three steps within 1e-6
  (measured 8.4e-8). After each step the parameters of the two ranks
  hash equal. Against the JAX step (float64) on the global batch, at
  tests/test_torch_train.py's tolerances: the loss rel 1e-5 (measured
  5.7e-7), the BN statistics atol 1e-5 (measured 6.0e-7), the parameters
  and the EMA more than 1e-5 apart on at most 1% of the coordinates and
  none more than 2 lr per update since the first (measured: none, and
  2.8e-6).
- Witnesses, run by the same ranks: per-rank BatchNorm (the sync turned
  off) and per-rank loss counts (each rank its own means) must each part
  from the one-rank step by more than those gates (measured: the step-1
  gradient 1.6 and 3.5 in L2; the per-rank BatchNorm's loss rel 6.0e-3).
- ``SOLVER.ACCUMULATE_STEPS`` 2: two calls, one update, against one rank,
  at the train step's gates (measured 1.1e-10 and 2.2e-9).
- Eval-loss step: the global batch's last row a padded one
  (``sample_valid`` False on rank 1): rel 1e-6 to one rank's loss of the
  three valid rows (measured 1.0e-7); the pad counted parts by 0.24.
- ``local_batch_size(3)`` at world size 2 raises ``ValueError``.
"""

import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from rtm3d_tpu_torch.config import default_config
from rtm3d_tpu_torch.data.targets import build_targets
from rtm3d_tpu_torch.losses.rtm3d_loss import rtm3d_loss
from rtm3d_tpu_torch.nn.layers import BatchNorm
from rtm3d_tpu_torch.nn.model import create_model
from rtm3d_tpu_torch.train.state import TrainState
from rtm3d_tpu_torch.train.step import make_eval_loss_step, make_train_step

REPO = Path(__file__).resolve().parents[1]
WORLD, B, N, HW = 2, 4, 6, 64
LOCAL = B // WORLD
STEPS = 3
TIMEOUT_S = 300
# the gates of a two-rank step against one rank (float64 network)
LOSS_REL, BUFFER_ATOL, GRAD_L2, GRAD_L2_TENSOR, PARAM_ATOL = 1e-6, 1e-7, 1e-8, 1e-6, 1e-6


def port_cfg(**solver):
    cfg = default_config()
    cfg.INPUT_SIZE = (HW, HW)
    cfg.BATCH_SIZE = B
    cfg.DATASET.MAX_OBJS = N
    cfg.SOLVER.BASE_LR = 1e-3
    cfg.SOLVER.WARMUP_ITERS = 2
    cfg.TPU.DONATE = False
    cfg.TPU.S2D_STEM = False
    cfg.SOLVER.update(solver)
    return cfg


def rows(tree, r):
    """Rank ``r``'s contiguous rows of a batch (nested dicts of arrays)."""
    if isinstance(tree, dict):
        return {k: rows(v, r) for k, v in tree.items()}
    return tree[r * LOCAL:(r + 1) * LOCAL]


def digest(model) -> str:
    h = hashlib.sha256()
    for _, p in model.named_parameters():
        h.update(p.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def grads_of(model) -> dict:
    return {k: torch.zeros_like(p) if p.grad is None else p.grad.detach().clone() for k, p in model.named_parameters()}


def buffers_of(model) -> dict:
    return {k: b.detach().clone() for k, b in model.named_buffers() if k.endswith(("running_mean", "running_var"))}


def new_state(inputs, cfg):
    """A float64 train state with EMA: the float32 gradient of this network
    carries about 1% of noise per tensor (tests/test_torch_train.py), which
    would hide what the ranks' collectives do; in float64 it does not."""
    model = create_model(cfg)
    model.load_state_dict(inputs["state_dict"], strict=True)
    state = TrainState.create(model, cfg, device="cpu", with_ema=True)
    state.model.double()
    state.ema = {k: v.double() for k, v in state.ema.items()}
    return state


def f64(batch):
    return dict(batch, image=batch["image"].astype(np.float64))


def bn_case(x, dy, bn_state):
    bn = BatchNorm(x.shape[1])
    bn.load_state_dict(bn_state)
    x = x.clone().requires_grad_()
    y = bn(x)
    (y * dy).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dw": bn.weight.grad, "db": bn.bias.grad,
            "running_mean": bn.running_mean, "running_var": bn.running_var}


def loss_case(logits, targets):
    logits = [l.clone().requires_grad_() for l in logits]
    loss, aux = rtm3d_loss(logits, targets)
    loss.backward()
    return {"aux": aux, "grads": [l.grad for l in logits]}


def train_run(inputs, cfg, batches):
    state = new_state(inputs, cfg)
    step = make_train_step(cfg, device="cpu")
    out = {"loss_items": [], "num_targets": [], "digests": [], "buffers": []}
    for i, b in enumerate(batches):
        state, m = step(state, f64(b))
        out["loss_items"].append(m["loss_items"].clone())
        out["num_targets"].append(int(m["num_targets"]))
        out["digests"].append(digest(state.model))
        out["buffers"].append(buffers_of(state.model))
        if i == 0:
            out["grads"] = grads_of(state.model)
    out["params"] = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    out["ema"] = None if state.ema is None else {k: v.clone() for k, v in state.ema.items()}
    out["last_grads"] = grads_of(state.model)
    out["updates"] = state.updates
    return out


def eval_run(inputs, cfg, batch):
    state = new_state(inputs, cfg)
    return make_eval_loss_step(cfg, device="cpu")(state, f64(batch))["loss_items"]


def _rank_main(workdir: str, rank: int) -> None:
    """One rank of the launch: every case on this rank's rows."""
    from rtm3d_tpu_torch.losses import rtm3d_loss as loss_mod
    from rtm3d_tpu_torch.nn import layers
    from rtm3d_tpu_torch.parallel import dist

    torch.set_num_threads(2)
    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    dist.init_distributed("cpu", init_method=f"file://{workdir}/store", rank=rank, world_size=WORLD, timeout=60)
    try:
        out = {"bn": bn_case(rows(inputs["bn_x"], rank), rows(inputs["bn_dy"], rank), inputs["bn_state"])}
        out["losses"] = {name: loss_case([rows(l, rank) for l in logits], rows(targets, rank))
                         for name, (logits, targets) in inputs["loss_cases"].items()}
        cfg = inputs["cfg"]
        mine = [rows(b, rank) for b in inputs["batches"]]
        # what the tests read, no more: the file is 0.9 GB as it is
        run = train_run(inputs, cfg, mine)
        keep = ("params", "ema", "grads", "buffers") if rank == 0 else ()
        out["train"] = {k: run[k] for k in ("loss_items", "num_targets", "digests") + keep}
        run = train_run(inputs, inputs["cfg_acc"], mine[:2])
        keep = ("params", "last_grads") if rank == 0 else ()
        out["accumulate"] = {k: run[k] for k in ("digests", "updates") + keep}
        out["eval"] = eval_run(inputs, cfg, rows(inputs["eval_batch"], rank))
        try:
            dist.local_batch_size(3)
        except ValueError as e:
            out["indivisible"] = str(e)
        # the witnesses: each collective of one kind turned off (the loss's
        # all-reduce of its counts, and the world size it scales by)
        one_rank = {"world_size": lambda: 1, "all_reduce_sum": lambda t: t}
        for name, mod, names in (("per_rank_bn", layers, ("world_size",)),
                                 ("per_rank_loss", loss_mod, ("world_size", "all_reduce_sum"))):
            saved = {k: getattr(mod, k) for k in names}
            for k in names:
                setattr(mod, k, one_rank[k])
            try:
                w = train_run(inputs, cfg, mine[:1])
            finally:
                for k, v in saved.items():
                    setattr(mod, k, v)
            # parts by O(1): float32 keeps it
            out[name] = {"loss_items": w["loss_items"], "grads": {k: g.float() for k, g in w["grads"].items()}
                         } if rank == 0 else {}
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.shutdown()


def wait_all(procs, timeout: float) -> None:
    """Wait for every process, at most ``timeout`` seconds in all; as soon
    as one fails (its peers would wait in a collective) or time runs out,
    kill the rest."""
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)


def launch(workdir: Path) -> list:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]),
               OMP_NUM_THREADS="2")
    procs = []
    for r in range(WORLD):
        with open(workdir / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen([sys.executable, __file__, str(workdir), str(r)], cwd=REPO, env=env,
                                          stdout=log, stderr=subprocess.STDOUT))
    wait_all(procs, TIMEOUT_S)
    for r, p in enumerate(procs):
        assert p.returncode == 0, (workdir / f"rank{r}.log").read_text()[-4000:]
    ranks = [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    for f in ["inputs.pt"] + [f"rank{r}.pt" for r in range(WORLD)]:  # a GB of files the suite need not keep
        (workdir / f).unlink()
    return ranks


def labels_batch(rng, b=B):
    """tests/test_train_step.py::synth_batch's label block, as numpy."""
    x1, y1 = rng.rand(b, N) * (HW - 20), rng.rand(b, N) * (HW - 20)
    labels = {
        "cls": rng.randint(0, 3, (b, N)).astype(np.int32),
        "bbox": np.stack([x1, y1, x1 + 15, y1 + 12], -1).astype(np.float32),
        "dim": (rng.rand(b, N, 3) + 0.5).astype(np.float32),
        "alpha": np.zeros((b, N), np.float32),
        "ry": rng.uniform(-1, 1, (b, N)).astype(np.float32),
        "loc": np.stack([rng.randn(b, N), rng.randn(b, N) * 0.2 + 1, rng.rand(b, N) * 20 + 8], -1).astype(np.float32),
        "K": np.tile(np.array([60.0, 0, HW / 2, 0, 60.0, HW / 2, 0, 0, 1], np.float32), (b, N, 1)),
        "mask": np.ones((b, N), bool),
        "noise_mask": np.zeros((b, N), bool),
    }
    return labels


def train_batch(seed):
    """A global batch whose two halves hold unequal counts: 11 objects on
    rank 0's rows (one slot padded out), 3 on rank 1's (one flagged as
    noise), so that per-rank means part from the global one."""
    rng = np.random.RandomState(seed)
    labels = labels_batch(rng)
    labels["mask"][0, N - 1] = False
    labels["mask"][2:, 2:] = False
    labels["noise_mask"][3, 1] = True
    return {"image": rng.rand(B, HW, HW, 3).astype(np.float32), "labels": labels}


def targets_of(labels):
    t = build_targets({k: torch.from_numpy(v) for k, v in labels.items()}, (HW // 4, HW // 4), 3)
    return {k: v for k, v in t.items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX reference, the inputs, the two-rank launch, and the one-rank
    runs of the same cases."""
    import jax
    import jax.numpy as jnp

    from rtm3d_tpu.config import default_config as default_config_jax
    from rtm3d_tpu.train import optim as optim_jax
    from rtm3d_tpu.train.state import TrainState as TrainStateJax
    from rtm3d_tpu.train.step import make_train_step as make_train_step_jax
    from tests.test_torch_model import jax_variables

    cfg = port_cfg()
    cfg_jax = default_config_jax()
    cfg_jax.INPUT_SIZE, cfg_jax.BATCH_SIZE, cfg_jax.DATASET.MAX_OBJS = (HW, HW), B, N
    cfg_jax.SOLVER.BASE_LR, cfg_jax.SOLVER.WARMUP_ITERS = 1e-3, 2
    cfg_jax.TPU.DONATE, cfg_jax.TPU.S2D_STEM = False, False
    jax_model, variables = jax_variables(cfg_jax, seed=2)
    batches = [train_batch(s) for s in (5, 6, 7)]

    torch.set_num_threads(2)
    model = create_model(cfg)
    from rtm3d_tpu_torch.train.checkpoint import state_dict_from_jax

    inputs = {"cfg": cfg, "cfg_acc": port_cfg(ACCUMULATE_STEPS=2), "batches": batches,
              "state_dict": state_dict_from_jax(variables, model)}
    rng = np.random.RandomState(11)
    inputs["bn_x"] = torch.from_numpy(rng.randn(B, 5, 3, 3).astype(np.float32) * 3 + 1)
    inputs["bn_dy"] = torch.from_numpy(rng.randn(B, 5, 3, 3).astype(np.float32))
    bn = BatchNorm(5)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(0))
        bn.bias.uniform_(-1, 1, generator=torch.Generator().manual_seed(1))
        bn.running_var.fill_(0.5)
    inputs["bn_state"] = bn.state_dict()
    cases = {}
    for name in ("unequal", "one_rank", "none"):
        labels = labels_batch(np.random.RandomState(12))
        if name == "unequal":
            labels["mask"][2:, 2:] = False
        elif name == "one_rank":
            labels["mask"][2:] = False
        else:
            labels["mask"][:] = False
        logits = [torch.from_numpy(rng.randn(B, c, HW // 4, HW // 4).astype(np.float32) * 2) for c in (3, 16, 2, 2)]
        cases[name] = (logits, targets_of(labels))
    inputs["loss_cases"] = cases
    eval_batch = train_batch(8)
    eval_batch["sample_valid"] = np.array([True, True, True, False])
    inputs["eval_batch"] = eval_batch

    workdir = tmp_path_factory.mktemp("ddp")
    torch.save(inputs, workdir / "inputs.pt")
    ranks = launch(workdir)

    one = {"bn": bn_case(inputs["bn_x"], inputs["bn_dy"], inputs["bn_state"]),
           "losses": {k: loss_case(*v) for k, v in cases.items()},
           "train": train_run(inputs, cfg, batches),
           "accumulate": train_run(inputs, inputs["cfg_acc"], batches[:2]),
           "eval": eval_run(inputs, cfg, {"image": eval_batch["image"][:3],
                                          "labels": {k: v[:3] for k, v in eval_batch["labels"].items()}}),
           "eval_padded_counted": eval_run(inputs, cfg, {k: v for k, v in eval_batch.items() if k != "sample_valid"})}

    to64 = lambda tree: jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64) if a.dtype == np.float32 else jnp.asarray(a), tree)
    with jax.enable_x64():
        v64 = to64(variables)
        tx, schedule = optim_jax.build_optimizer(cfg_jax, v64["params"])
        step_fn = make_train_step_jax(jax_model, cfg_jax, tx)
        state, metrics = TrainStateJax.create(v64, tx, with_ema=True), []
        for b in batches:
            state, m = step_fn(state, to64(b))
            metrics.append(jax.device_get(m))
        state = jax.device_get(state)
    lrs = [float(schedule(i)) for i in range(STEPS)]
    ref = {"metrics": metrics, "state": state, "lrs": lrs}
    return {"ranks": ranks, "one": one, "jax": ref, "model": model}


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def l2(a, b):
    return float((a - b).norm() / b.norm())


def flat(tree):
    return torch.cat([v.reshape(-1) for v in tree.values()])


@pytest.mark.parametrize("key", ["y", "dx", "dw", "db", "running_mean", "running_var"])
def test_sync_batchnorm_equals_one_rank_on_the_whole_batch(world, key):
    ranks, one = world["ranks"], world["one"]["bn"]
    if key in ("dw", "db"):
        got = ranks[0]["bn"][key] + ranks[1]["bn"][key]
    elif key in ("y", "dx"):
        got = torch.cat([r["bn"][key] for r in ranks])
    else:
        got = ranks[0]["bn"][key]
        assert torch.equal(got, ranks[1]["bn"][key])
    assert rel(got, one[key]) <= 1e-6, rel(got, one[key])


@pytest.mark.parametrize("case", ["unequal", "one_rank", "none"])
def test_global_count_loss_equals_one_rank(world, case):
    ranks, one = world["ranks"], world["one"]["losses"][case]
    for r in ranks:
        torch.testing.assert_close(r["losses"][case]["aux"], one["aux"], rtol=1e-6, atol=1e-9)
    if case == "none":
        assert one["aux"][2] == 0 and one["aux"][3] == 0  # no selection, as one rank gives
    for i, g in enumerate(one["grads"]):
        got = torch.cat([r["losses"][case]["grads"][i] for r in ranks]) / WORLD
        if not g.any():  # no selection: no gradient
            assert not got.any(), i
            continue
        assert rel(got, g) <= 1e-6, (i, rel(got, g))


def params_apart(got: dict, want: dict, atol: float):
    diff = torch.cat([(got[k] - want[k]).abs().reshape(-1) for k in want])
    return float((diff > atol).double().mean()), float(diff.max())


def test_train_steps_equal_one_rank(world):
    r0, r1, one = world["ranks"][0]["train"], world["ranks"][1]["train"], world["one"]["train"]
    assert r0["digests"] == r1["digests"]  # the ranks hold the same parameters after each step
    assert len(set(r0["digests"])) == STEPS
    for i in range(STEPS):
        for r in (r0, r1):
            torch.testing.assert_close(r["loss_items"][i], one["loss_items"][i], rtol=LOSS_REL, atol=0)
            assert r["num_targets"][i] == one["num_targets"][i]
        for k, v in one["buffers"][i].items():
            torch.testing.assert_close(r0["buffers"][i][k], v, rtol=0, atol=BUFFER_ATOL)
    per = {k: l2(r0["grads"][k], g) for k, g in one["grads"].items() if g.norm() > 0}
    assert l2(flat(r0["grads"]), flat(one["grads"])) <= GRAD_L2 and max(per.values()) <= GRAD_L2_TENSOR
    for got, want in ((r0["params"], one["params"]), (r0["ema"], one["ema"])):
        assert params_apart(got, want, PARAM_ATOL)[0] == 0


def test_train_steps_match_jax_on_the_global_batch(world):
    r0, ref = world["ranks"][0]["train"], world["jax"]
    from rtm3d_tpu_torch.train.checkpoint import state_dict_from_jax

    model = world["model"]
    for i in range(STEPS):
        np.testing.assert_allclose(r0["loss_items"][i][4].item(), float(ref["metrics"][i]["loss"]), rtol=1e-5)
        assert r0["num_targets"][i] == int(ref["metrics"][i]["num_targets"])
    s = ref["state"]
    sd = state_dict_from_jax({"params": s.params, "batch_stats": s.batch_stats}, model)
    for k, v in r0["buffers"][-1].items():
        np.testing.assert_allclose(v.numpy(), sd[k].numpy(), atol=1e-5, rtol=0, err_msg=k)
    ema = state_dict_from_jax({"params": s.ema_params, "batch_stats": s.batch_stats}, model)
    bound = 2 * sum(ref["lrs"][1:])
    for got, want in ((r0["params"], sd), (r0["ema"], ema)):
        share, worst = params_apart(got, {k: want[k] for k in got}, 1e-5)
        assert share <= 0.01 and worst <= bound, (share, worst)


@pytest.mark.parametrize("witness", ["per_rank_bn", "per_rank_loss"])
def test_witnesses_part_from_one_rank(world, witness):
    """The gates above separate right from wrong: each collective turned
    off on its own moves the step-1 gradient past the gradient gate."""
    w, one = world["ranks"][0][witness], world["one"]["train"]
    assert l2(flat(w["grads"]).double(), flat(one["grads"])) > 1e6 * GRAD_L2
    if witness == "per_rank_bn":
        assert abs(w["loss_items"][0][4] - one["loss_items"][0][4]) > 1e3 * LOSS_REL * one["loss_items"][0][4]


def test_accumulated_steps_equal_one_rank(world):
    r0, r1, one = (world["ranks"][0]["accumulate"], world["ranks"][1]["accumulate"], world["one"]["accumulate"])
    assert r0["updates"] == r1["updates"] == one["updates"] == 1
    assert r0["digests"] == r1["digests"] and r0["digests"][0] != r0["digests"][1]
    assert l2(flat(r0["last_grads"]), flat(one["last_grads"])) <= GRAD_L2
    assert params_apart(r0["params"], one["params"], PARAM_ATOL)[0] == 0


def test_eval_loss_leaves_padded_rows_out(world):
    want = world["one"]["eval"]
    for r in world["ranks"]:
        torch.testing.assert_close(r["eval"], want, rtol=LOSS_REL, atol=0)
    assert not torch.allclose(world["one"]["eval_padded_counted"], want, rtol=1e-4)


def test_indivisible_global_batch_raises(world):
    for r in world["ranks"]:
        assert "not divisible by the world size 2" in r["indivisible"]


def test_one_process_helpers_are_the_identity():
    """With no process group every helper is the one-process path: world 1,
    rank 0, the master, the batch whole, the collectives the identity."""
    from rtm3d_tpu_torch.parallel import dist

    assert not dist.initialized() and dist.world_size() == 1 and dist.rank() == 0 and dist.is_master()
    assert dist.local_batch_size(7) == 7
    t = torch.arange(3.0)
    assert dist.all_reduce_sum(t) is t and torch.equal(t, torch.arange(3.0))
    box = {"a": [1.5]}
    assert dist.broadcast_object(box) is box
    dist.sync_processes("test")
    dist.warmup_collectives("cpu")
    dist.shutdown()  # nothing to leave


def test_device_for_rank(monkeypatch):
    from rtm3d_tpu_torch.parallel import dist

    monkeypatch.setenv("LOCAL_RANK", "3")
    assert dist.device_for_rank() == torch.device("cuda", 3)
    assert dist.device_for_rank("cuda") == torch.device("cuda", 3)
    assert dist.device_for_rank("cuda:1") == torch.device("cuda", 1)
    assert dist.device_for_rank("cpu") == torch.device("cpu")


def test_init_asks_for_the_card_and_has_no_fallback(tmp_path):
    """Asked for a CUDA device where there is none, the initialisation
    raises (there is no fallback to the CPU), and leaves no group."""
    from rtm3d_tpu_torch.parallel import dist

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist.init_distributed("cuda:0", init_method=f"file://{tmp_path}/store", rank=0, world_size=1, timeout=60)
    assert not dist.initialized()


def test_directory_checkpoint_round_trip_is_bit_exact(tmp_path):
    """``TRAINING.USE_ORBAX``'s directory save at one process, after a step
    (so the optimizer holds state), loaded into a fresh state: every
    tensor, counter and hyperparameter bit for bit; the detector serves its
    EMA as from a ``.pt`` file."""
    from rtm3d_tpu_torch.train.checkpoint import CheckPointer, is_checkpoint_dir, load_detect_weights
    from rtm3d_tpu_torch.utils.measure import state_tensors, unequal

    torch.set_num_threads(2)
    cfg = port_cfg()
    state = TrainState.create(create_model(cfg), cfg, device="cpu", with_ema=True)
    state, _ = make_train_step(cfg, device="cpu")(state, train_batch(5))
    ckpt = CheckPointer(str(tmp_path / "w"), use_orbax=True)
    try:
        path = ckpt.save("model_0000000", state, epoch=0, min_loss=1.5)
        assert is_checkpoint_dir(path) and ckpt.get_checkpoint_file() == path
        fresh = TrainState.create(create_model(cfg, torch.Generator().manual_seed(9)), cfg, device="cpu",
                                  with_ema=True)
        fresh, meta = ckpt.load(fresh)
        assert meta == {"epoch": 0, "min_loss": 1.5}
        assert unequal(state_tensors(fresh), state_tensors(state)) == []
        served = create_model(cfg, torch.Generator().manual_seed(9))
        assert "(EMA weights)" in load_detect_weights(path, served)
        for k, p in served.named_parameters():
            assert torch.equal(p, state.ema[k]), k
    finally:
        shutil.rmtree(tmp_path / "w")  # 460 MB the suite need not keep


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
