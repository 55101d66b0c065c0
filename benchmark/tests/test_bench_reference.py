"""The port agrees with the plain reference on seeded weights, at a tiny
size on the CPU, stage by stage: the input stage, both networks, the
decode, the 3D solve, the targets, the loss and three training steps."""

import json

import numpy as np
import pytest
import torch

from benchmark import gen, judge
from benchmark.drivers import train as train_driver
from benchmark.program import TrainState, make_train_step, port_config, port_model
from benchmark.reference import decode as rd
from benchmark.reference import inputs as ri
from benchmark.reference import train as rt
from benchmark.reference.network import build_network
from conftest import ROOT, TINY_HW

torch.set_num_threads(4)


def conf(name: str) -> dict:
    c = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
    c["config"]["INPUT_SIZE"] = TINY_HW
    c["config"]["TPU"]["COMPUTE_DTYPE"] = "float32"
    c["config"]["DATASET"]["MAX_OBJS"] = 8
    return c


def both(name: str, seed: int = 3, train: bool = False):
    c = conf(name)
    sd = gen.make_weights(c, seed, "cpu", "float32")
    prog = port_model(port_config(c), sd, torch.device("cpu"))
    ref = build_network(c)
    ref.load_state_dict(sd, strict=True)
    prog.train(train)
    ref.train(train)
    return c, prog, ref


@pytest.mark.parametrize("name", ["rtm3d_dla34_kitti", "rtm3d_resnet18_kitti"])
def test_networks_agree(name):
    c, prog, ref = both(name)
    x = torch.randn(2, 3, TINY_HW[1], TINY_HW[0], generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for a, b in zip(prog(x), ref(x)):
            assert torch.allclose(a, b, rtol=1e-4, atol=1e-5), float((a - b).abs().max())


def test_input_stage_agrees():
    from rtm3d_tpu_torch.ops.device_warp import device_warp
    from rtm3d_tpu_torch.train.step import normalize_images, prepare_images

    c = conf("rtm3d_dla34_kitti")["config"]
    W, H = c["INPUT_SIZE"]
    imgs = gen.frames(5, 2, 3, (60, 124), "cpu")
    params = []
    for scale, mirror in ((1.0, False), (1.15, True), (1.07, False)):
        p, _ = gen.warp_params((60, 124), (W, H), W, scale, mirror)
        params.append(np.concatenate([p, [124 - 3 * mirror, 60]]))
    params = torch.tensor(np.asarray(params, np.float32))
    border = imgs.float().mean(dim=(1, 2))
    want = ri.warp(imgs, params, (H, W), c["DATASET"]["MEAN"], c["DATASET"]["STD"], border)
    got = device_warp(imgs, params, (H, W), c["DATASET"]["MEAN"], c["DATASET"]["STD"], border=border)
    assert torch.allclose(got, want, atol=1e-5)
    assert torch.allclose(normalize_images(imgs, port_config({"config": c})), ri.normalize(imgs, c["DATASET"]["MEAN"], c["DATASET"]["STD"]))
    photo = torch.tensor([[1.1, 0.05, 3.0, 12345.0], [1.0, 0.0, 0.0, 7.0], [0.9, -0.1, 5.0, 2 ** 31 - 2]])
    cfg = port_config({"config": c})
    got = prepare_images({"image": imgs, "warp": params, "photo": photo, "border": border}, cfg)
    want = ri.warp(ri.photometric(imgs, photo), params, (H, W), c["DATASET"]["MEAN"], c["DATASET"]["STD"], border)
    assert torch.allclose(got, want, atol=1e-5)


def test_decode_and_solve_agree():
    from rtm3d_tpu_torch.decode.peaks import decode_detections
    from rtm3d_tpu_torch.train.step import attach_3d

    c, prog, ref = both("rtm3d_resnet18_kitti")
    cfg = port_config(c)
    K = torch.tensor(np.tile(gen.input_K(gen.kitti_K((60, 124)), gen.warp_params((60, 124), TINY_HW, TINY_HW[0])[0]), (2, 1, 1)))
    sd = gen.make_weights(c, 3, "cpu", "float32")
    gen.draw_car(sd, K[0].numpy(), 100.0, 4.0, "float32")
    ref.load_state_dict(sd)
    x = torch.randn(2, 3, TINY_HW[1], TINY_HW[0], generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits = ref(x)
    want = rd.detect(logits, K, c)
    d = c["config"]["DETECTOR"]
    got = decode_detections(logits, d["SCORE_THRESH"], d["TOPK_CANDIDATES"], 4.0)
    got = attach_3d(got, K, cfg)
    for k in ("cls", "valid", "accepted"):
        assert torch.equal(got[k].to(want[k].dtype), want[k]), k
    for k in ("scores", "m_proj", "v_proj", "bbox2d", "dim", "loc", "cost"):
        assert torch.allclose(got[k], want[k], rtol=1e-4, atol=1e-4), (k, float((got[k] - want[k]).abs().max()))
    nums = judge.detect_numbers({k: v.numpy() for k, v in got.items()}, logits, K, c)
    assert nums["score_gap"] < 1e-6 and nums["accept_flip_pct"] == 0
    assert nums["peak_gap"] == 0 and nums["topk_gap"] == 0


def test_targets_and_loss_agree():
    from rtm3d_tpu_torch.data.targets import build_targets
    from rtm3d_tpu_torch.losses.rtm3d_loss import rtm3d_loss

    c = conf("rtm3d_dla34_kitti")
    W, H = TINY_HW
    rng = gen.host_rng(4, 5)
    K = np.tile(gen.input_K(gen.kitti_K((60, 124)), gen.warp_params((60, 124), (W, H), W)[0]), (2, 1, 1))
    labels = {k: torch.as_tensor(v) for k, v in gen.labels(rng, 2, 8, 4.7, K, (W, H), c["config"]["DETECTOR"]["dim_ref"]).items()}
    labels["noise_mask"][0, 0] = True
    got = build_targets(labels, (H // 4, W // 4), 3)
    want = rt.build_targets(labels, (H // 4, W // 4), 3, 4.0)
    assert torch.equal(got["m_hm"].permute(0, 2, 3, 1), want["m_hm"])
    for k in ("m_proj", "v_proj", "v_mask", "mask_3d", "mask"):
        assert torch.equal(got[k], want[k]), k
    for k in ("m_off", "v_off", "v_coor_off"):
        assert torch.allclose(got[k], want[k], atol=1e-5), k
    _, prog, ref = both("rtm3d_dla34_kitti", train=True)
    x = torch.randn(2, 3, H, W, generator=torch.Generator().manual_seed(2))
    logits = ref(x)
    total, _ = rtm3d_loss(logits, got)
    assert torch.allclose(total, rt.loss(logits, want, (1.0, 1.0, 0.5, 0.5)), rtol=1e-5)


def test_three_training_steps_agree(tmp_path):
    c = conf("rtm3d_dla34_kitti")
    traffic = json.loads((ROOT / "benchmark" / "traffic" / "cache_b32.json").read_text())
    traffic.update(batch=2, canvas_hw=[60, 124], dataset_frames=8)
    dev = torch.device("cpu")
    cfg = port_config(c)
    sd = gen.make_weights(c, 21, dev, "float32")
    state = TrainState.create(port_model(cfg, sd, dev), cfg, device=dev)
    cache, batches = train_driver.dataset(c, traffic, 21, dev)
    _, prog = train_driver.program_readings(state, make_train_step(cfg, device=dev), batches, cache, 3)
    ref = train_driver.reference_readings(c, sd, batches[:3], cache, dev)
    assert sum(int(b["labels"]["mask"].sum()) for b in batches[:3]) > 0
    nums = judge.train_numbers(prog, ref, sd)
    # the first step's loss to float32 rounding; later steps part further:
    # Adamax moves an element whose gradient is near its rounding noise by
    # a whole step either way
    assert abs(prog["loss"][0] - ref["loss"][0]) <= 1e-5 * abs(ref["loss"][0])
    assert nums["loss_gap"] < 5e-3 and nums["grad_gap"] < 0.05 and nums["change_gap"] < 0.1, nums


def test_steps_after_the_window_agree():
    """The reference going on from the program's own state (its leaves,
    Adamax moments, update count and EMA), as a run's check after its
    window does, follows the program's next three steps."""
    c = conf("rtm3d_dla34_kitti")
    traffic = json.loads((ROOT / "benchmark" / "traffic" / "cache_b32.json").read_text())
    traffic.update(batch=2, canvas_hw=[60, 124], dataset_frames=10)
    dev = torch.device("cpu")
    cfg = port_config(c)
    sd = gen.make_weights(c, 22, dev, "float32")
    state = TrainState.create(port_model(cfg, sd, dev), cfg, device=dev)
    step = make_train_step(cfg, device=dev)
    cache, batches = train_driver.dataset(c, traffic, 22, dev)
    for b in batches[:2]:
        state, _ = step(state, b, cache)
    state, start, late = train_driver.late_readings(state, step, batches[2:5], cache, 3)
    assert start["t"] == 2 and start["ema"] is not None
    ref = train_driver.reference_readings(c, sd, batches[2:5], cache, dev, start=start)
    nums = judge.train_numbers(late, ref, start["params"], prefix="late_", ema_init=start["ema"])
    assert abs(late["loss"][0] - ref["loss"][0]) <= 1e-5 * abs(ref["loss"][0])
    assert nums["late_loss_gap"] < 5e-3 and nums["late_change_gap"] < 0.1 and nums["late_ema_gap"] < 0.1, nums
