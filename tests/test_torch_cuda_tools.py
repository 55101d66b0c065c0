"""Card tests of the tenth slice: ``TPU.REMAT`` on the GPU, and the port's
benches (``rtm3d_tpu_torch/tools/``) through the kernels.

Like tests/test_torch_cuda.py this file imports neither JAX nor the JAX
package; on a machine with a CUDA device, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_tools.py -q

Without a device every ``cuda``-marked test skips with its reason.

- A DLA-34 384x128 b2 fp32 step with REMAT against the same step without,
  TF32 off, cuDNN's deterministic algorithms: the loss, aux and each
  gradient within 1e-6 relative (``chip_smoke.py``'s remat_check gate),
  and every BN's ``num_batches_tracked`` counted once.
- ``bench_latency``'s ``bench_batch`` at b1 (a small frame): 2 LM kernel
  launches a call and device percentiles from CUDA events.
- ``bench_train``'s step-only bench, one timed step: 1 splat kernel launch.
"""

import numpy as np
import pytest
import torch

from rtm3d_tpu_torch.config import default_config
from rtm3d_tpu_torch.nn.model import create_model
from rtm3d_tpu_torch.ops import lm_solver, splat
from rtm3d_tpu_torch.tools import bench_latency, bench_train
from rtm3d_tpu_torch.train.state import TrainState
from rtm3d_tpu_torch.train.step import make_detect_step, make_train_step
from rtm3d_tpu_torch.utils.measure import synthetic_labels


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the GPU paths have no CPU mode")
    was = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    yield torch.device("cuda")
    (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) = was


@pytest.mark.cuda
def test_remat_step_equals_the_step_without(cuda):
    cfg = default_config()
    cfg.INPUT_SIZE = (384, 128)
    model = create_model(cfg, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(3)
    batch = {"image": torch.from_numpy((rng.rand(2, 128, 384, 3) * 255).astype(np.uint8)),
             "labels": synthetic_labels(rng, 2, 64, scale=0.3)}
    runs = {}
    for remat in (False, True):
        cfg.TPU.REMAT = remat
        state = TrainState.create(model, cfg, device=cuda)
        state, m = make_train_step(cfg, device=cuda)(state, batch)
        runs[remat] = (m["loss_items"].double().cpu(),
                       {k: p.grad.double().cpu() for k, p in state.model.named_parameters() if p.grad is not None},
                       {k: int(v) for k, v in state.model.named_buffers() if k.endswith("num_batches_tracked")})
    (aux_off, g_off, n_off), (aux_on, g_on, n_on) = runs[False], runs[True]
    torch.testing.assert_close(aux_on, aux_off, rtol=1e-6, atol=0)
    assert set(g_on) == set(g_off)
    for k, g in g_off.items():
        assert float((g_on[k] - g).norm()) <= 1e-6 * float(g.norm()), k
    assert n_on == n_off and set(n_on.values()) == {1}


@pytest.mark.cuda
def test_b1_latency_call_launches_the_lm_pair(cuda):
    cfg = bench_latency.bench_config("DLA-34", "bfloat16", (128, 384))
    detect = make_detect_step(create_model(cfg, torch.Generator().manual_seed(0)), cfg, device=cuda)
    r = bench_latency.bench_batch(detect, 1, 3, cuda, (128, 384))
    assert r["launches_per_call"]["lm"] == 2 and lm_solver.lm_solve.launches == 6
    assert set(r["device"]) == {"p50_ms", "p90_ms", "p99_ms", "mean_ms", "per_image_ms"}
    assert 0 < r["device"]["p50_ms"] and np.isfinite(r["wall"]["p50_ms"])


@pytest.mark.cuda
def test_bench_train_step_launches_the_splat(cuda):
    out = bench_train.run(bench_train.parse_args(["--batch", "2", "--iters", "1"]), (128, 384), say=lambda *a: None)
    line = out["step_only"]
    assert line["splat_launches_per_step"] == 1 and splat.splat_heatmap.launches == 1
    assert line["metric"] == "train_step_images_per_sec_dla34_b2_384x128_float32"
    assert np.isfinite(line["loss"]) and line["peak_mem_gb"] > 0 and line["tf32"]["cudnn_allow_tf32"] is False
