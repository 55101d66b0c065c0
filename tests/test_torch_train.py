"""The port's training slice against the JAX package's, on the CPU.

DLA-34 at 64x64, batch 2, MAX_OBJS 6, the JAX weights (with BN statistics
drawn at random) carried across by ``state_dict_from_jax``, labels as
tests/test_train_step.py:31-56 with one padded and one noise-flagged slot.
The JAX package runs its plain stem (``TPU.S2D_STEM`` off), the branch the
port ports. The JAX programs (value-and-grad, train step, eval step) are
traced once for the module, in float64: at this size the JAX package's
float32 gradients on the CPU sit 1.4% (median per-tensor L2) from its own
float64 ones, where the port's float32 sit 1e-4 from the port's float64.
The port runs in float32 except where a test says otherwise.

Tolerances, each measured here first:
- loss and aux on the same logits and targets: rel 1e-5 (measured 2.7e-7);
- gradients in float64 on both sides: each tensor within 1e-6 of its max
  |g| (measured 3.1e-7; the loss itself is float32 in both); the port in
  float32: per-tensor L2 within 1e-2 (measured 4.6e-3 on this batch,
  1.4% on the second one); the stop-grad biases exactly 0 on both sides;
- one train step: loss and aux rel 1e-5 (measured 3.3e-6), BN running
  mean and variance atol 1e-5 (measured 3.6e-6); the parameters after an
  update of lr 1e-6, where Adamax's first step is lr times the sign of
  the gradient: at most 1e-3 of them more than 1e-7 apart (measured
  7.3e-5, coordinates whose |g| is at float32's floor), none more than
  2 lr apart;
- a second step at lr 5e-4: parameters and EMA more than 1e-5 apart on at
  most 1% of coordinates (measured 0.50%), none more than 2 lr (measured
  7.3e-4);
- eval loss on the same state, with the EMA shadow apart from the params
  (7% apart in loss): rel 1e-5 (measured 3.6e-7);
- accumulation: the applied gradient within 1e-2 L2 of the mean of JAX's
  two, the parameters as after one step (at most 1% of coordinates 1e-7
  apart, measured 0.14%).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtm3d_tpu.config import default_config
from rtm3d_tpu.data.targets import build_targets as build_targets_jax
from rtm3d_tpu.losses.rtm3d_loss import rtm3d_loss as rtm3d_loss_jax
from rtm3d_tpu.train import optim as optim_jax
from rtm3d_tpu.train.state import TrainState as TrainStateJax
from rtm3d_tpu.train.step import _loss_from_batch as loss_from_batch_jax
from rtm3d_tpu.train.step import make_eval_loss_step as make_eval_loss_step_jax
from rtm3d_tpu.train.step import make_train_step as make_train_step_jax
from rtm3d_tpu_torch.losses.rtm3d_loss import rtm3d_loss
from rtm3d_tpu_torch.nn.layers import BatchNorm
from rtm3d_tpu_torch.nn.model import create_model
from rtm3d_tpu_torch.train import optim
from rtm3d_tpu_torch.train.checkpoint import _flatten, _to_dotted, state_dict_from_jax
from rtm3d_tpu_torch.train.state import TrainState
from rtm3d_tpu_torch.train.step import _loss_from_batch, _to_device, make_eval_loss_step, make_train_step
from tests.test_torch_model import jax_variables
from tests.test_train_step import synth_batch

B, N, HW = 2, 6, 64


def train_cfg(**solver):
    cfg = default_config()
    cfg.INPUT_SIZE = (HW, HW)
    cfg.BATCH_SIZE = B
    cfg.DATASET.MAX_OBJS = N
    cfg.SOLVER.BASE_LR = 1e-3
    cfg.SOLVER.WARMUP_ITERS = 2
    cfg.TPU.DONATE = False
    # the JAX package's plain stem, the one the port runs (its train-only
    # space-to-depth stem is not ported, nn/dla.py)
    cfg.TPU.S2D_STEM = False
    cfg.SOLVER.update(solver)
    return cfg


def make_batch(seed, b=B):
    """tests/test_train_step.py's batch as numpy, one slot padded out and
    one flagged as noise so that every branch of the targets runs."""
    batch = jax.tree_util.tree_map(np.array, synth_batch(np.random.RandomState(seed), B=b, N=N, hw=(HW, HW)))
    batch["labels"]["mask"][0, N - 1] = False
    batch["labels"]["noise_mask"][b - 1, 1] = True
    return batch


def to_jax(batch):
    return jax.tree_util.tree_map(jnp.asarray, batch)


def by_port_name(tree, model, batch_stats):
    """A JAX params-shaped tree (params, grads, EMA) as {port name: numpy},
    the parameters only."""
    sd = state_dict_from_jax({"params": tree, "batch_stats": batch_stats}, model)
    names = {n for n, _ in model.named_parameters()}
    return {k: v.numpy() for k, v in sd.items() if k in names}


@pytest.fixture(scope="module")
def ref():
    return build_ref()


def build_ref():
    """The JAX programs' outputs, computed in float64 (``jax.enable_x64``):
    at this size the JAX package's float32 gradients on the CPU sit 1.4%
    (median per-tensor L2) from its own float64 ones, the port's float32
    1e-4 from its float64, so the reference is taken in float64 and the
    port held to it in float32."""
    cfg = train_cfg()
    jax_model, variables = jax_variables(cfg, seed=2)
    batches = [make_batch(5), make_batch(6)]
    f64 = lambda tree: jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64) if a.dtype == np.float32 else jnp.asarray(a), tree)
    with jax.enable_x64():
        v64 = f64(variables)
        tx, _ = optim_jax.build_optimizer(cfg, v64["params"])

        @jax.jit
        def grad_fn(params, batch_stats, batch):
            loss_fn = loss_from_batch_jax(jax_model, cfg, params, batch_stats, batch, train=True)
            return jax.value_and_grad(loss_fn, has_aux=True)(params)

        grads = [jax.device_get(grad_fn(v64["params"], v64["batch_stats"], f64(b))) for b in batches]
        step_fn = make_train_step_jax(jax_model, cfg, tx)
        states, metrics = [TrainStateJax.create(v64, tx, with_ema=True)], []
        for b in batches:
            s, m = step_fn(states[-1], f64(b))
            states.append(s)
            metrics.append(jax.device_get(m))
        # the EMA shadow set apart from the params (the initial weights), so
        # that evaluating the params instead would show
        eval_out = jax.device_get(make_eval_loss_step_jax(jax_model, cfg)(
            states[-1].replace(ema_params=v64["params"]), f64(batches[0])))
        states = [jax.device_get(s) for s in states]
    return {
        "cfg": cfg, "variables": variables, "batches": batches, "grads": grads,
        "states": states, "metrics": metrics, "eval": eval_out,
    }


def port_state(ref, cfg=None, with_ema=True):
    cfg = cfg or ref["cfg"]
    model = create_model(cfg)
    model.load_state_dict(state_dict_from_jax(ref["variables"], model), strict=True)
    return TrainState.create(model, cfg, device="cpu", with_ema=with_ema)


def params_np(state):
    return {k: p.detach().numpy().copy() for k, p in state.model.named_parameters()}


@pytest.mark.parametrize("case", ["plain", "sample_mask", "empty"])
def test_loss_matches_jax(ref, case):
    rng = np.random.RandomState(7)
    labels = ref["batches"][0]["labels"]
    if case == "empty":  # every slot noise: both L1 offset terms select nothing
        labels = dict(labels, noise_mask=np.ones_like(labels["noise_mask"]))
    t_jax = jax.device_get(build_targets_jax(to_jax(labels), (HW // 4, HW // 4), 3))
    t_port = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in t_jax.items()}
    t_port["m_hm"] = t_port["m_hm"].permute(0, 3, 1, 2)
    logits = [rng.randn(B, HW // 4, HW // 4, c).astype(np.float32) * 2 for c in (3, 16, 2, 2)]
    sample_mask = np.array([True, False]) if case == "sample_mask" else None
    want, want_aux = rtm3d_loss_jax([jnp.asarray(l) for l in logits], t_jax,
                                    sample_mask=None if sample_mask is None else jnp.asarray(sample_mask))
    got, got_aux = rtm3d_loss([torch.from_numpy(l).permute(0, 3, 1, 2) for l in logits], t_port,
                              sample_mask=None if sample_mask is None else torch.from_numpy(sample_mask))
    assert got_aux.shape == (5,) and torch.isfinite(got_aux).all()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(got_aux.numpy(), np.asarray(want_aux), rtol=1e-5, atol=1e-7)
    if case == "empty":
        assert got_aux[2].item() == 0.0 and got_aux[3].item() == 0.0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_gradients_match_jax(ref, dtype):
    state = port_state(ref)
    net = state.model.to(dtype)
    batch = _to_device(ref["batches"][0], torch.device("cpu"))
    batch["image"] = batch["image"].to(dtype)
    loss, _ = _loss_from_batch(net, ref["cfg"], batch)
    loss.backward()
    (want_loss, _), want = ref["grads"][0]
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = by_port_name(want, net, ref["variables"]["batch_stats"])
    stopped = {k for k, p in net.named_parameters() if p.grad is None}
    # no gradient in the port, exactly 0 in JAX: the 8 header ConvLevel
    # biases (stop_bias_grad) and the dead projections of the level-2 trees
    # (nn/dla.py: computed and dropped in JAX, skipped in the port)
    biases = {k for k in stopped if k.startswith("detect_header.")}
    assert len(biases) == 8 and all(k.endswith(".bias") for k in biases)
    assert stopped - biases == {f"backbone.level{i}.project.{j}" for i in (3, 4) for j in
                                ("0.weight", "1.weight", "1.bias")}
    assert {k for k, g in want.items() if not g.any()} == stopped
    for k, p in net.named_parameters():
        if k in stopped:
            continue
        g, w = p.grad.numpy(), want[k]
        if dtype == torch.float64:
            np.testing.assert_allclose(g, w, atol=1e-6 * np.abs(w).max(), rtol=0, err_msg=k)
        else:
            assert np.linalg.norm(g - w) <= 1e-2 * np.linalg.norm(w), k


def test_train_step_matches_jax(ref):
    state = port_state(ref)
    before = params_np(state)
    step = make_train_step(ref["cfg"], device="cpu")
    state, m = step(state, ref["batches"][0])
    want = ref["metrics"][0]
    assert state.step == 1 and state.updates == 1
    np.testing.assert_allclose(m["loss"].item(), float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(m["loss_items"].numpy(), want["loss_items"], rtol=1e-5)
    assert m["loss_items"][4].item() == m["loss"].item()
    assert int(m["num_targets"]) == int(want["num_targets"]) == B * N - 1

    s1 = ref["states"][1]
    sd = state_dict_from_jax({"params": s1.params, "batch_stats": s1.batch_stats}, state.model)
    for k, buf in state.model.named_buffers():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), sd[k].numpy(), atol=1e-5, rtol=0, err_msg=k)
    got = params_np(state)
    diff = np.concatenate([np.abs(v - sd[k].numpy()).ravel() for k, v in got.items()])
    assert (diff > 1e-7).mean() <= 1e-3 and diff.max() <= 2e-6 + 1e-7, ((diff > 1e-7).mean(), diff.max())
    # the stopped biases moved by coupled decay alone, as in JAX
    assert any(not np.array_equal(got[k], before[k]) for k in got if "header.0.bias" in k)

    state, m = step(state, ref["batches"][1])
    np.testing.assert_allclose(m["loss"].item(), float(ref["metrics"][1]["loss"]), rtol=1e-5)
    s2 = ref["states"][2]
    lr = ref["cfg"].SOLVER.BASE_LR * (0.001 * 0.5 + 0.5)  # the schedule at update 1
    for got_tree, want_tree in ((params_np(state), s2.params), (state.ema, s2.ema_params)):
        want_np = by_port_name(want_tree, state.model, s2.batch_stats)
        diff = np.concatenate([np.abs(np.asarray(got_tree[k]) - want_np[k]).ravel() for k in want_np])
        assert (diff > 1e-5).mean() <= 0.01 and diff.max() <= 2 * lr, ((diff > 1e-5).mean(), diff.max())


def test_eval_step_matches_jax_and_drops_padded_rows(ref):
    s2 = ref["states"][2]
    model = create_model(ref["cfg"])
    model.load_state_dict(state_dict_from_jax({"params": s2.params, "batch_stats": s2.batch_stats}, model))
    state = TrainState.create(model, ref["cfg"], device="cpu", with_ema=False)
    initial = port_state(ref, with_ema=False).model
    state.ema = {k: p.detach().clone() for k, p in initial.named_parameters()}
    eval_step = make_eval_loss_step(ref["cfg"], device="cpu")
    got = eval_step(state, ref["batches"][0])
    np.testing.assert_allclose(got["loss"].item(), float(ref["eval"]["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["loss_items"].numpy(), ref["eval"]["loss_items"], rtol=1e-5)
    assert state.model.training  # the eval step leaves the mode as it found it
    params_only = eval_step(dataclasses.replace(state, ema=None), ref["batches"][0])["loss"].item()
    assert abs(params_only - got["loss"].item()) > 1e-3 * got["loss"].item()  # the EMA was evaluated

    # rows 2 and 3 play the wrap-around filler (DataLoader.pad_final)
    full, sub = make_batch(8, b=4), make_batch(8, b=4)
    sub = {"image": sub["image"][:2], "labels": {k: v[:2] for k, v in sub["labels"].items()}}
    want = eval_step(state, sub)["loss_items"]
    torch.testing.assert_close(eval_step(state, full, num_valid=2)["loss_items"], want, rtol=2e-5, atol=0)
    flagged = dict(full, sample_valid=np.array([True, True, False, False]))
    torch.testing.assert_close(eval_step(state, flagged)["loss_items"], want, rtol=2e-5, atol=0)
    assert not torch.allclose(eval_step(state, full)["loss_items"], want, rtol=1e-6)


def test_accumulation_matches_optax_multisteps(ref):
    cfg = train_cfg(ACCUMULATE_STEPS=2)
    state = port_state(ref, cfg, with_ema=False)
    before = params_np(state)
    step = make_train_step(cfg, device="cpu")
    state, _ = step(state, ref["batches"][0])
    assert state.updates == 0 and all(np.array_equal(v, before[k]) for k, v in params_np(state).items())
    state, _ = step(state, ref["batches"][1])
    assert state.step == 2 and state.updates == 1
    # the applied gradient is the mean of the two (port f32, JAX f64)
    g1, g2 = (by_port_name(g, state.model, ref["variables"]["batch_stats"]) for _, g in ref["grads"])
    for k, p in state.model.named_parameters():
        scale = (np.linalg.norm(g1[k]) + np.linalg.norm(g2[k])) / 2
        assert np.linalg.norm(p.grad.numpy() - (g1[k] + g2[k]) / 2) <= 1e-2 * scale, k

    params = ref["variables"]["params"]
    tx, _ = optim_jax.build_optimizer(cfg, params)
    opt = tx.init(params)
    for _, g in ref["grads"]:
        upd, opt = tx.update(g, opt, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, upd)
    want = by_port_name(jax.device_get(params), state.model, ref["variables"]["batch_stats"])
    diff = np.concatenate([np.abs(v - want[k]).ravel() for k, v in params_np(state).items()])
    assert (diff > 1e-7).mean() <= 1e-2 and diff.max() <= 2e-6 + 1e-7, ((diff > 1e-7).mean(), diff.max())


def test_frozen_scope_does_not_move(ref):
    cfg = train_cfg(EXCLUDE_SCOPE=("backbone",), WARMUP_ITERS=0)
    state = port_state(ref, cfg, with_ema=False)
    before = params_np(state)
    state, _ = make_train_step(cfg, device="cpu")(state, ref["batches"][0])
    after = params_np(state)
    frozen = [k for k in after if k.startswith("backbone.")]
    assert frozen and all(np.array_equal(after[k], before[k]) for k in frozen)
    assert all(not np.array_equal(after[k], before[k]) for k in after if not k.startswith("backbone."))


@pytest.mark.parametrize("scopes", [(), ("backbone",), ("backbone/level2", "detect_header/main_kf")])
def test_param_groups_match_jax_key_by_key(ref, scopes):
    model = create_model(ref["cfg"])
    got = optim.param_groups(model, scopes)
    want = {
        _to_dotted(path): label
        for path, label in _flatten(jax.device_get(optim_jax.param_groups(ref["variables"]["params"], scopes))).items()
    }
    assert got == want
    assert set(got.values()) == {"weight", "bias", "norm"} | ({"frozen"} if scopes else set())


def test_schedules_match_jax():
    # tests/test_train_step.py:59-83's values
    sched = optim.warmup_multistep_schedule(0.01, (10, 20), 0.1, warmup_factor=0.001, warmup_iters=5)
    assert sched(0) == pytest.approx(0.01 * 0.001)
    assert sched(2) == pytest.approx(0.01 * (0.001 * (1 - 0.4) + 0.4))
    assert sched(7) == pytest.approx(0.01)
    assert sched(12) == pytest.approx(0.001, rel=1e-5)
    assert sched(25) == pytest.approx(0.0001, rel=1e-5)
    for s, n in [(7, 0), (12, 1), (25, 2), (10**6, 2)]:
        assert sched(s) == pytest.approx(float(0.01 * jnp.power(jnp.float32(0.1), jnp.float32(n))), rel=1e-6)
    cfg = default_config()
    for name in ("WarmupMultiStepLR", "WarmupCosineLR"):
        cfg.SOLVER.LR_SCHEDULER_NAME = name
        cfg.SOLVER.WARMUP_METHOD = "linear" if name == "WarmupCosineLR" else "constant"
        got, want = optim.build_lr_schedule(cfg, 60000), optim_jax.build_lr_schedule(cfg, 60000)
        for s in (0, 1, 500, 999, 1000, 20000, 50001, 59999):
            # abs: at the end of the cosine, 1 + cos is 0 in float32, 7e-12 in float64
            assert got(s) == pytest.approx(float(want(s)), rel=1e-6, abs=1e-10), (name, s)


def test_bn_running_variance_is_biased_as_in_flax():
    """At 2x2 maps and batch 2 (n = 8, the stride-32 level at 64x64) the
    unbiased variance is 14% above the biased one; the port folds in the
    biased one, as flax does (momentum 0.03)."""
    import flax.linen as fnn

    x = np.random.RandomState(0).randn(2, 5, 2, 2).astype(np.float32) * 3 + 1
    bn = BatchNorm(5).train()
    bn.running_var.fill_(0.5)
    bn(torch.from_numpy(x))
    layer = fnn.BatchNorm(use_running_average=False, momentum=0.97, epsilon=1e-4)
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    v = layer.init(jax.random.PRNGKey(0), xj)
    v = {"params": v["params"], "batch_stats": {"mean": v["batch_stats"]["mean"],
                                                "var": jnp.full((5,), 0.5, jnp.float32)}}
    _, mut = layer.apply(v, xj, mutable=["batch_stats"])
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(mut["batch_stats"]["var"]), rtol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(mut["batch_stats"]["mean"]), atol=1e-7)
    biased = x.var(axis=(0, 2, 3))
    np.testing.assert_allclose(bn.running_var.numpy(), 0.97 * 0.5 + 0.03 * biased, rtol=1e-6)
