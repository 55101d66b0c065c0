"""Card tests of the ResNet and export slice: a ResNet-18 detect step and
train step on the GPU against the CPU, and an artifact of ``cli.export``
made on the CPU with ``--platforms cpu,cuda`` served on the GPU, with the
LM kernel's 2 launches a call.

Like tests/test_torch_cuda.py this file imports neither JAX nor the JAX
package; on a machine with a CUDA device, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_resnet.py -q

Without a device every ``cuda``-marked test skips with its reason. TF32 is
off in each test (fp32 against the CPU).
"""

import os

import numpy as np
import pytest
import torch

from rtm3d_tpu_torch.cli import export
from rtm3d_tpu_torch.config import load_config
from rtm3d_tpu_torch.nn.model import create_model
from rtm3d_tpu_torch.ops.lm_solver import lm_solve
from rtm3d_tpu_torch.ops.splat import splat_heatmap
from rtm3d_tpu_torch.train.state import TrainState
from rtm3d_tpu_torch.train.step import make_detect_step, make_detect_step_from_export, make_train_step

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
                      "rtm3d_resnet18_kitti.yaml")
SET = ["INPUT_SIZE", "(96, 64)", "DATASET.MAX_OBJS", "8", "DETECTOR.TOPK_CANDIDATES", "10"]
K = np.tile(np.array([[60.0, 0, 48], [0, 60, 32], [0, 0, 1]], np.float32), (2, 1, 1))


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the GPU paths have no CPU mode")
    was = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = was


def images(seed=9):
    return torch.from_numpy((np.random.RandomState(seed).rand(2, 64, 96, 3) * 255).astype(np.uint8))


def assert_detections_close(got, ref):
    for k in ref:
        assert got[k].shape == ref[k].shape, k
    torch.testing.assert_close(got["scores"].cpu(), ref["scores"], atol=1e-4, rtol=1e-4)
    assert torch.equal(got["cls"].cpu(), ref["cls"]) and torch.equal(got["valid"].cpu(), ref["valid"])
    torch.testing.assert_close(got["v_proj"].cpu(), ref["v_proj"], atol=1e-2, rtol=1e-4)


@pytest.mark.cuda
def test_resnet18_detect_step_gpu_matches_cpu(cuda):
    cfg = load_config(CONFIG, SET)
    model = create_model(cfg, torch.Generator().manual_seed(0))
    before = lm_solve.launches
    got = make_detect_step(model, cfg, device="cuda")(images(), K)
    torch.cuda.synchronize()
    assert lm_solve.launches == before + 2 and all(v.device.type == "cuda" for v in got.values())
    assert_detections_close(got, make_detect_step(model, cfg, device="cpu")(images(), K))


@pytest.mark.cuda
def test_resnet18_train_step_gpu_matches_cpu(cuda):
    cfg = load_config(CONFIG, SET)
    model = create_model(cfg, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(2)
    B, N = 2, 8
    x1, y1 = rng.rand(B, N) * 70, rng.rand(B, N) * 44
    labels = {
        "cls": rng.randint(0, 3, (B, N)).astype(np.int32),
        "bbox": np.stack([x1, y1, x1 + 22, y1 + 16], -1).astype(np.float32),
        "dim": (rng.rand(B, N, 3) + 0.8).astype(np.float32), "alpha": np.zeros((B, N), np.float32),
        "ry": rng.uniform(-3, 3, (B, N)).astype(np.float32),
        "loc": np.stack([rng.randn(B, N), rng.randn(B, N) * 0.2 + 1, rng.rand(B, N) * 20 + 8], -1).astype(np.float32),
        "K": np.tile(np.array([60.0, 0, 48, 0, 60.0, 32, 0, 0, 1], np.float32), (B, N, 1)),
        "mask": rng.rand(B, N) > 0.2, "noise_mask": rng.rand(B, N) > 0.9,
    }
    batch = {"image": images(3).numpy(), "labels": labels}
    out = {}
    for dev in ("cuda", "cpu"):
        state = TrainState.create(model, cfg, device=dev)
        before = splat_heatmap.launches
        state, m = make_train_step(cfg, device=dev)(state, batch)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert splat_heatmap.launches == before + 1
        stats = torch.cat([b.flatten().float().cpu() for k, b in state.model.named_buffers() if "running" in k])
        out[dev] = (m["loss_items"].cpu(), torch.cat([p.grad.flatten().cpu() for p in state.model.parameters()]),
                    stats)
    (ag, gg, sg), (ac, gc, sc) = out["cuda"], out["cpu"]
    torch.testing.assert_close(ag, ac, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(sg, sc, rtol=1e-4, atol=1e-5)
    # float32 noise at random init, as DLA-34's (tests/test_torch_cuda.py)
    assert ((gg - gc).norm() / gc.norm()).item() <= 5e-2


@pytest.mark.cuda
@pytest.mark.parametrize("with_decode", [True, False])
def test_cpu_made_artifact_serves_on_the_gpu(cuda, tmp_path, with_decode):
    """One artifact, traced on the CPU for ``cpu,cuda``: on the GPU it gives
    the CPU's detections (the eager step's tolerances above), through 2 LM
    launches a call; the decode runs in the artifact or after it."""
    cfg = load_config(CONFIG, SET)
    model = create_model(cfg, torch.Generator().manual_seed(0))
    weights = str(tmp_path / "weights.pt")
    torch.save(model.state_dict(), weights)
    path = str(tmp_path / "model.pt2")
    export.main(["--model-config", CONFIG, "--output", path, "--checkpoint", weights, "--batch-size", "2",
                 "--device", "cpu", "--platforms", "cpu,cuda", "--set", *SET]
                + (["--with-decode"] if with_decode else []))
    on_gpu = export.load_exported(path, "cuda")
    assert on_gpu.platforms == ["cpu", "cuda"] and next(on_gpu.module.parameters()).is_cuda
    step = make_detect_step_from_export(on_gpu, cfg, device="cuda")
    before = lm_solve.launches
    for seed in (9, 10):
        got = step(images(seed), K)
        torch.cuda.synchronize()
        ref = make_detect_step_from_export(export.load_exported(path, "cpu"), cfg, device="cpu")(images(seed), K)
        assert_detections_close(got, ref)
    assert lm_solve.launches == before + 4
    with pytest.raises(ValueError, match="loaded on"):
        make_detect_step_from_export(on_gpu, cfg, device="cpu")
