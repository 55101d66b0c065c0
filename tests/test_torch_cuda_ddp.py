"""The data-parallel path on the card: NCCL at world size 1 takes the path
of a run with no process group (``parallel/dist.py``: every collective is
skipped at one rank), so its train step equals that run's bit for bit.

This file imports neither JAX nor the JAX package. On a machine with a
CUDA device, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_ddp.py -q

Without a device the test skips with its reason. Two ranks need two
processes: ``chip_smoke.py``'s ``ddp_*`` phases run them on the card.
"""

import os

import numpy as np
import pytest
import torch

from rtm3d_tpu_torch.config import default_config
from rtm3d_tpu_torch.nn import layers
from rtm3d_tpu_torch.nn.model import create_model
from rtm3d_tpu_torch.parallel import dist
from rtm3d_tpu_torch.train.state import TrainState
from rtm3d_tpu_torch.train.step import make_train_step
from rtm3d_tpu_torch.utils.measure import state_tensors, synthetic_labels, unequal

# cuBLAS reads its workspace size once, at its first call: set it before any
# test of the session runs (collection imports every module first)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


@pytest.fixture()
def deterministic_cuda():
    """The CUDA device, with TF32 off and every op on a deterministic path
    (an op without one raises), for the test; the settings restored after."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL and the CUDA kernels have no CPU mode")
    saved = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield torch.device("cuda")
    finally:
        torch.use_deterministic_algorithms(saved[0])
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved[1:]


@pytest.mark.cuda
def test_nccl_world1_step_equals_no_process_group_step(deterministic_cuda, tmp_path):
    """DLA-34 384x128 batch 2 fp32 (TF32 off) with EMA, two steps from the
    same weights, with no process group and under NCCL at world size 1,
    with deterministic algorithms: the losses, the last gradients and every
    tensor of the state (parameters, BN statistics, Adamax's moments, the
    EMA) bit-equal. The witness: the synchronised BatchNorm taken at the
    one rank (its arithmetic differs from ``F.batch_norm``'s in the last
    bits) must break the equality."""
    cuda = deterministic_cuda
    cfg = default_config()
    cfg.INPUT_SIZE = (384, 128)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    model = create_model(cfg, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(3)
    batches = [{"image": torch.from_numpy((rng.rand(2, 128, 384, 3) * 255).astype(np.uint8)),
                "labels": synthetic_labels(rng, 2, 16, scale=0.3)} for _ in range(2)]

    def run():
        state = TrainState.create(model, cfg, device=cuda, with_ema=True)
        step = make_train_step(cfg, device=cuda)
        losses = [step(state, b)[1]["loss_items"].cpu() for b in batches]
        grads = {f"grad.{k}": p.grad.detach().clone() for k, p in state.model.named_parameters()}
        return {**{f"loss{i}": v for i, v in enumerate(losses)}, **grads, **state_tensors(state)}

    plain = run()
    dist.init_distributed(cuda, init_method=f"file://{tmp_path}/store", rank=0, world_size=1, timeout=60)
    try:
        assert torch.distributed.get_backend() == "nccl" and dist.world_size() == 1
        dist.warmup_collectives(cuda)
        nccl = run()
        saved, layers.world_size = layers.world_size, lambda: 2  # the witness: _SyncBatchNorm at one rank
        try:
            witness = run()
        finally:
            layers.world_size = saved
    finally:
        dist.shutdown()
    assert all(torch.isfinite(plain[f"loss{i}"]).all() for i in range(2))
    assert unequal(nccl, plain) == []
    assert unequal(witness, plain) != []
