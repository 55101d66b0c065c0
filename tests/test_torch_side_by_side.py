"""The side-by-side mode of the port's ``tools/ap_parity.py``
(``run_ap_parity``) against the JAX tool's, on the CPU.

- ``tools/twin.py``: the seed-5 twin's state dict equals the JAX tool's
  ``build_torch_twin(5, backbone)`` bit for bit for both backbones (its
  SHA-256 is ``TWIN_SHA256``, which the card's phase checks), leaves the
  global generator as it was, and loads strict into the port's model; for
  ResNet-18 the torchvision-layout import (``import_reference_weights``)
  takes every tensor too. The port's BatchNorms train with the twin's
  eps 1e-4 and momentum 0.03.
- ``tools/reference_train.py``: ``reference_loss`` equals
  ``tests/test_train_parity.py::_torch_loss`` bit for bit, value and
  gradients, on the port's targets; ``reference_optimizer``'s groups and
  one step equal ``_torch_optimizer``'s on the same twin.
- The reference leg's first loss at the JAX 100-step record's recipe
  (ResNet-18, input 256, 64 train frames, b8, seed 20, the augmented
  stream) is the record's 1,218.7838 within 1e-5 relative (measured
  1,218.7882, 3.6e-6: cv2 5.0 on the CPU warps the record's frames).
- A small run of both tools in one process (input 128 on 96x128 frames,
  16 train and 8 test frames, b4, 10 steps; of the JAX tool, its training
  loop, :298-408, without its checkpoints and serving legs, whose three
  detect compiles and scipy solves took 50 s more here): the augmented
  float batches equal the JAX tool's, pixels and labels; the reference
  leg's losses equal the JAX tool's torch leg at step 0 and stay within
  2e-2 over the 10 steps (measured 4.5e-3 at step 9: the port's targets differ from the
  JAX package's by float32 ulps, m_hm <= 5e-7 and v_off <= 4e-6, and ten
  Adamax steps amplify them); the port leg's drift against the JAX leg
  (measured 6.8e-7 at step 0, <= 1.1e-2 over the 10) is within the
  bounds of tests/test_ap_parity.py:41-47 (drift[0] < 5e-3, the first 10
  < 5e-2, every step < 0.5, the last losses within 25%); the report has
  the JAX tool's keys with the port's leg names; every AP cell's
  ``delta_samew`` within tests/test_ap_parity.py:59's 5 points.
- A second call reloads both legs' weights and curves and trains
  nothing (the serving legs stubbed with the first call's result dirs);
  ``rescore_only`` scores the
  four directories again; a run cut after 3 of 6 steps (input 64, b2)
  resumes from its mid checkpoint (step 2) to the uninterrupted losses of
  both legs, bit for bit.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax
from rtm3d_tpu.data.kitti import create_dataset as create_dataset_jax
from rtm3d_tpu.data.loader import DataLoader as DataLoaderJax
from rtm3d_tpu.data.targets import build_targets as build_targets_jax
from rtm3d_tpu.train.checkpoint import import_torch_weights
from rtm3d_tpu.train.state import TrainState as TrainStateJax
from rtm3d_tpu_torch.data.kitti import create_dataset
from rtm3d_tpu_torch.data.loader import DataLoader
from rtm3d_tpu_torch.data.targets import build_targets
from rtm3d_tpu_torch.nn.layers import BatchNorm
from rtm3d_tpu_torch.nn.model import create_model
from rtm3d_tpu_torch.tools import ap_parity, reference_train, twin
from rtm3d_tpu_torch.train.checkpoint import import_reference_weights
from tests.test_train_parity import _torch_loss, _torch_optimizer
from tools import ap_parity as ap_jax

SMALL = dict(img_hw=(96, 128), input_size=128, num_train=16, num_test=8, steps=10, batch=4)
RECORD_100 = "docs/experiments/ap_parity_100step_report.json"
RECORD_FIRST_REL = 1e-5
REFERENCE_GAP = {"step0": 1e-6, "all": 2e-2}
JAX_HARNESS = {"drift0": 5e-3, "first10": 5e-2, "every": 0.5, "last_rel": 0.25, "delta_samew": 5.0}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("backbone", twin.BACKBONES)
def test_twin_is_the_jax_tools_bit_for_bit(backbone):
    before = torch.random.get_rng_state()
    got = twin.build_torch_twin(5, backbone).state_dict()
    assert torch.equal(torch.random.get_rng_state(), before)
    want = ap_jax.build_torch_twin(5, backbone).state_dict()
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
    assert twin.state_dict_sha256(got) == twin.state_dict_sha256(want) == twin.TWIN_SHA256[backbone]

    cfg = ap_parity.make_config("/data", 128, 4, 1e-3, backbone)
    model = twin.load_twin(create_model(cfg), got)
    sd = model.state_dict()
    assert all(torch.equal(sd[k], got[k]) for k in got)
    if backbone == "RESNET-18":  # the torchvision-layout route, key for key
        other = create_model(cfg)
        report = import_reference_weights(other, got)
        assert not report["missed"] and all(a == b for a, b in report["loaded"])
        assert len(report["loaded"]) == sum(not k.endswith("num_batches_tracked") for k in got)
        assert all(torch.equal(other.state_dict()[k], got[k]) for k, _ in report["loaded"])
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    twin_bns = [m for m in ap_jax.build_torch_twin(5, backbone).modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert len(bns) == len(twin_bns) and all(isinstance(m, BatchNorm) for m in bns)
    assert {(m.eps, m.momentum) for m in bns} == {(m.eps, m.momentum) for m in twin_bns} == {(1e-4, 0.03)}


def labels_block(rng, B=2, N=4, hw=(64, 64)):
    """A label block of ``B`` frames with ``N`` slots (the last slot of
    each frame padding), boxes inside an ``hw`` input."""
    h, w = hw
    x0 = rng.uniform(0, w / 2, (B, N)).astype(np.float32)
    y0 = rng.uniform(h / 3, h / 2, (B, N)).astype(np.float32)
    bbox = np.stack([x0, y0, x0 + rng.uniform(8, w / 2, (B, N)), y0 + rng.uniform(8, h / 2, (B, N))], -1)
    K = np.tile(np.array([60, 0, w / 2, 0, 60, h / 2, 0, 0, 1], np.float32), (B, N, 1))
    loc = np.stack([rng.uniform(-3, 3, (B, N)), rng.uniform(1, 2, (B, N)), rng.uniform(8, 30, (B, N))], -1)
    mask = np.ones((B, N), bool)
    mask[:, -1] = False
    return {"cls": rng.randint(0, 3, (B, N)).astype(np.int32), "bbox": bbox.astype(np.float32),
            "dim": rng.uniform(1, 4, (B, N, 3)).astype(np.float32), "alpha": np.zeros((B, N), np.float32),
            "ry": rng.uniform(-3, 3, (B, N)).astype(np.float32), "loc": loc.astype(np.float32), "K": K,
            "mask": mask, "noise_mask": np.zeros((B, N), bool)}


def test_reference_loss_and_optimizer_are_the_test_helpers(rng):
    labels = {k: torch.as_tensor(v) for k, v in labels_block(rng).items()}
    t = reference_train.to_reference_targets(build_targets(labels, (16, 16), 3))
    assert t["mask_3d"].any() and t["v_mask"].any()
    shapes = ((2, 3, 16, 16), (2, 16, 16, 16), (2, 2, 16, 16), (2, 2, 16, 16))
    logits = [torch.tensor(rng.randn(*s).astype(np.float32), requires_grad=True) for s in shapes]
    got = reference_train.reference_loss(logits, t)
    g_got = torch.autograd.grad(got, logits)
    want = _torch_loss(logits, t)
    g_want = torch.autograd.grad(want, logits)
    assert torch.equal(got, want) and all(torch.equal(a, b) for a, b in zip(g_got, g_want))

    a, b = twin.build_torch_twin(5), twin.build_torch_twin(5)
    hyper = (1e-3, 1e-4, 0.0, 0.0, 2.0)
    opt_a, opt_b = reference_train.reference_optimizer(a, *hyper), _torch_optimizer(b, *hyper)
    groups = [(len(g["params"]), g["lr"], g["weight_decay"]) for g in opt_a.param_groups]
    assert groups == [(len(g["params"]), g["lr"], g["weight_decay"]) for g in opt_b.param_groups]
    assert groups[1][1] == 2e-3 and groups[2][0] == 2 * sum(isinstance(m, torch.nn.BatchNorm2d) for m in a.modules())
    x = torch.tensor(rng.randn(2, 3, 64, 64).astype(np.float32))
    for net, opt, loss in ((a, opt_a, reference_train.reference_loss), (b, opt_b, _torch_loss)):
        net.train()
        opt.zero_grad()
        loss(net(x), t).backward()
        opt.step()
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_reference_first_loss_reproduces_the_record(tmp_path):
    with open(os.path.join(REPO, RECORD_100)) as f:
        record = json.load(f)
    c = record["config"]
    data = ap_parity.fixture(str(tmp_path), c["input"][0], c["num_train"], c["num_test"], seed=20)
    cfg = ap_parity.make_config(data, c["input"][0], c["batch"], c["lr"])
    ds = create_dataset(data, cfg, is_training=True, split="train")
    _, b = next(ap_parity.step_stream(DataLoader(ds, c["batch"], shuffle=True, seed=20), 1, 0))
    w, h = ds.img_size
    t = reference_train.to_reference_targets(build_targets(
        {k: torch.as_tensor(v) for k, v in b["labels"].items()}, (h // 4, w // 4), 3))
    net = twin.build_torch_twin(5).train()
    with torch.no_grad():
        first = float(reference_train.reference_loss(net(torch.from_numpy(b["image"]).permute(0, 3, 1, 2)), t))
    want = record["loss_torch_first_last"][0]
    assert abs(first - want) <= RECORD_FIRST_REL * want, (first, want)


def jax_tool_training(work: str, img_hw, input_size: int, num_train: int, num_test: int, steps: int,
                      batch: int, seed: int = 20, lr: float = 1e-3):
    """The JAX tool's side-by-side training (tools/ap_parity.py:298-408),
    its checkpoints and serving left out: the JAX leg from the imported
    twin and the twin with ``_torch_loss`` and ``_torch_optimizer`` on the
    JAX targets of the same batches. Returns both legs' losses."""
    data = ap_jax._fixture(work, input_size, num_train, num_test, seed, img_hw)
    cfg = ap_jax.make_config(data, input_size, batch, lr)
    twin_jax = ap_jax.build_torch_twin()
    ds = create_dataset_jax(data, cfg, is_training=True, split="train")
    _, variables, tx, _, train_step = ap_jax._init_jax_stack(cfg, ds)
    variables, report = import_torch_weights(variables, {k: v.detach().numpy()
                                                         for k, v in twin_jax.state_dict().items()})
    assert not report["missed"], report["missed"][:8]
    state = TrainStateJax.create(variables, tx)
    w, h = cfg.INPUT_SIZE
    build_tgts = jax.jit(lambda labels: build_targets_jax(labels, (h // 4, w // 4), 3))
    s = cfg.SOLVER
    topt = _torch_optimizer(twin_jax, s.BASE_LR, s.WEIGHT_DECAY, s.WEIGHT_DECAY_BIAS, s.WEIGHT_DECAY_NORM,
                            s.BIAS_LR_FACTOR)
    twin_jax.train()
    loader = DataLoaderJax(ds, batch, shuffle=True, seed=seed, num_shards=1, shard_index=0)
    loss_jax, loss_torch = [], []
    for _, b in ap_jax._step_stream(loader, steps, 0):
        imgs = b["image"].astype(np.float32)
        labels = {k: jnp.asarray(v) for k, v in b["labels"].items()}
        targets = build_tgts(labels)
        state, metrics = train_step(state, {"image": jnp.asarray(imgs), "labels": labels})
        t = {k: torch.as_tensor(np.asarray(v).copy()) for k, v in targets.items()}
        topt.zero_grad()
        tl = _torch_loss(twin_jax(torch.as_tensor(imgs.transpose(0, 3, 1, 2))), t)
        tl.backward()
        topt.step()
        loss_jax.append(float(metrics["loss"]))
        loss_torch.append(float(tl.detach()))
    return loss_jax, loss_torch


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("side_by_side")
    return root, ap_parity.run_ap_parity(str(root / "port"), progress=lambda *a: None, device="cpu", **SMALL)


def test_the_batches_are_the_jax_tools(tmp_path):
    data = ap_parity.fixture(str(tmp_path), 128, 6, 1, seed=20, img_hw=(96, 128))
    cfg, cfg_jax = ap_parity.make_config(data, 128, 3, 1e-3), ap_jax.make_config(data, 128, 3, 1e-3)
    ds = create_dataset(data, cfg, is_training=True, split="train")
    ds_jax = create_dataset_jax(data, cfg_jax, is_training=True, split="train")
    got = [b for _, b in ap_parity.step_stream(DataLoader(ds, 3, shuffle=True, seed=20), 4, 0)]
    want = [b for _, b in ap_jax._step_stream(DataLoaderJax(ds_jax, 3, shuffle=True, seed=20, num_shards=1,
                                                            shard_index=0), 4, 0)]
    for b, w in zip(got, want):
        assert b["image"].dtype == np.float32 and np.array_equal(b["image"], w["image"])
        assert list(b["path"]) == list(w["path"]) and b["labels"].keys() == w["labels"].keys()
        for k in w["labels"]:
            np.testing.assert_array_equal(np.asarray(b["labels"][k]), np.asarray(w["labels"][k]), err_msg=k)
    assert not np.array_equal(got[0]["image"], got[2]["image"])  # augmented, two epochs of 2 batches


def test_small_run_against_the_jax_tool(port_run):
    root, port = port_run
    with open(root / "port" / "losses.json") as f:
        curves = json.load(f)
    curves_jax = dict(zip(("jax", "torch"), jax_tool_training(str(root / "jax"), **SMALL)))
    ref = [abs(a - b) / abs(b) for a, b in zip(curves["torch"], curves_jax["torch"])]
    print(f"reference leg against the JAX tool's torch leg: {['%.1e' % r for r in ref]}")
    assert ref[0] <= REFERENCE_GAP["step0"] and max(ref) < REFERENCE_GAP["all"], ref
    drift = [abs(a - b) / abs(b) for a, b in zip(curves["port"], curves_jax["jax"])]
    print(f"port leg against the JAX leg: {['%.1e' % r for r in drift]}")
    h = JAX_HARNESS
    assert drift[0] < h["drift0"] and max(drift[:10]) < h["first10"] and max(drift) < h["every"], drift
    for curve in (curves["port"], curves["torch"]):
        assert curve[-1] < curve[0]
    assert abs(curves["port"][-1] - curves_jax["jax"][-1]) / curves_jax["jax"][-1] < h["last_rel"]
    assert port["loss_drift_curve"] == [abs(a - b) / abs(b) for a, b in zip(curves["port"], curves["torch"])]

    assert set(port) == {"config", "loss_port_first_last", "loss_torch_first_last", "loss_drift_curve",
                         "max_drift_first_50", "final_drift", "ap", "accepted_counts", "legs", "train"}
    assert port["config"]["mode"] == "side_by_side" and port["config"]["input"] == [128, 96]
    assert port["config"]["twin_sha256"] == twin.TWIN_SHA256["RESNET-18"]
    assert len(port["ap"]) == 27
    for key, row in port["ap"].items():
        assert set(row) == {"port", "torch", "delta", "int8", "delta_int8", "samew", "delta_samew"}
        assert abs(row["delta_samew"]) <= h["delta_samew"], (key, row)
    train = port["train"]
    assert train["steps_run"] == 10 and train["port"]["tf32"] == {"cudnn": True, "matmul": True}
    assert train["torch"]["tf32"] == {"cudnn": False, "matmul": False}
    assert train["port"]["splat_launches"] == train["torch"]["splat_launches"] == 0  # the CPU's plain splat
    assert set(port["legs"]) == {"port", "torch", "int8", "samew"}
    for leg in ("port", "torch", "int8", "samew"):
        assert len(os.listdir(root / "port" / f"results_{leg}")) == 8


def test_second_call_serves_without_training_and_rescore(port_run, monkeypatch):
    root, port = port_run
    monkeypatch.setattr(ap_parity, "make_train_step", None)
    trained = {name: torch.load(root / "port" / f"{name}_final.pt", weights_only=True) for name in ("port", "twin")}
    served = []

    def serve_again(cfg, model, eval_ds, calib_ds, batch, work_dir, device, progress, reference, samew):
        # the first call's result dirs: serving again writes the same lines (the legs are deterministic on
        # the CPU), and the reference leg's scipy solves would take most of this test's time
        for net, name in ((model, "port"), (reference, "twin"), (samew, "twin")):
            sd = net.state_dict()
            served.append(all(torch.equal(sd[k].cpu(), v) for k, v in trained[name].items()))
        return ({leg: os.path.join(work_dir, f"results_{leg}") for leg in ap_parity.SIDE_BY_SIDE_LEGS},
                port["legs"])

    monkeypatch.setattr(ap_parity, "serve_legs", serve_again)
    again = ap_parity.run_ap_parity(str(root / "port"), progress=lambda *a: None, device="cpu", **SMALL)
    assert again["train"] == {"steps_run": 0} and served == [True, True, True]
    for key in ("loss_port_first_last", "loss_torch_first_last", "loss_drift_curve", "ap", "accepted_counts"):
        assert again[key] == port[key], key
    kw = {k: SMALL[k] for k in ("img_hw", "input_size", "num_train", "num_test")}
    out = ap_parity.run_ap_parity(str(root / "port"), rescore_only=True, min_overlap=0.3, min_height=0.0,
                                  bootstrap=5, progress=lambda *a: None, **kw)
    assert set(out) == {"config", "ap", "bootstrap"} and out["config"]["min_overlap"] == 0.3
    assert set(out["bootstrap"]["Car_bbox_moderate"]) == {"delta_ci95", "delta_int8_ci95", "delta_samew_ci95"}
    with pytest.raises(FileNotFoundError):
        ap_parity.run_ap_parity(str(root / "empty"), rescore_only=True, **kw)


def test_cut_run_resumes_to_the_uninterrupted_losses(tmp_path, monkeypatch):
    kw = dict(input_size=64, num_train=4, num_test=1, steps=6, batch=2, save_every=2, device="cpu",
              progress=lambda *a: None)
    monkeypatch.setattr(ap_parity, "serve_legs", lambda *a, **k: ({}, {}))
    monkeypatch.setattr(ap_parity, "score_legs", lambda *a, **k: {})
    monkeypatch.setattr(ap_parity, "count_accepted", lambda d: 0)
    whole = ap_parity.run_ap_parity(str(tmp_path / "whole"), **kw)
    make = ap_parity.make_train_step

    def cut_after_3(cfg, device=None):
        step, calls = make(cfg, device=device), []

        def train_step(state, batch, cache=None):
            calls.append(1)
            if len(calls) > 3:
                raise RuntimeError("cut")
            return step(state, batch, cache)

        return train_step

    monkeypatch.setattr(ap_parity, "make_train_step", cut_after_3)
    with pytest.raises(RuntimeError, match="cut"):
        ap_parity.run_ap_parity(str(tmp_path / "cut"), **kw)
    assert os.path.exists(tmp_path / "cut" / "train_ckpt.pt") and not os.path.exists(tmp_path / "cut" / "losses.json")
    monkeypatch.setattr(ap_parity, "make_train_step", make)
    resumed = ap_parity.run_ap_parity(str(tmp_path / "cut"), **kw)
    assert resumed["train"]["first_step"] == 2 and resumed["train"]["steps_run"] == 4
    with open(tmp_path / "whole" / "losses.json") as f, open(tmp_path / "cut" / "losses.json") as g:
        a, b = json.load(f), json.load(g)
    assert a == b and len(a["port"]) == len(a["torch"]) == 6
    for name in ("port_final.pt", "twin_final.pt"):
        sa = torch.load(tmp_path / "whole" / name, weights_only=True)
        sb = torch.load(tmp_path / "cut" / name, weights_only=True)
        assert all(torch.equal(sa[k], sb[k]) for k in sa), name
    assert whole["loss_drift_curve"] == resumed["loss_drift_curve"]
