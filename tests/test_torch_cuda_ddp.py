"""The data-parallel path on the card: NCCL at world size 1 takes the path
of a run with no process group (``parallel/dist.py``: every collective is
skipped at one rank), so its train step equals that run's bit for bit.

This file imports neither JAX nor the JAX package. On a machine with a
CUDA device, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_ddp.py -q

Without a device the tests skip with their reason. Two ranks need two
processes: ``chip_smoke.py``'s ``ddp_*`` and ``spatial`` phases run them
on the card, and so does the halo-exchange test below (this file run as
a script, two gloo ranks sharing the card: NCCL refuses two ranks on one
device).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rtm3d_tpu_torch.config import default_config
from rtm3d_tpu_torch.nn import layers
from rtm3d_tpu_torch.nn.model import create_model
from rtm3d_tpu_torch.parallel import dist, spatial
from rtm3d_tpu_torch.train.state import TrainState
from rtm3d_tpu_torch.train.step import make_train_step
from rtm3d_tpu_torch.utils.measure import state_tensors, synthetic_labels, unequal
from tests.test_torch_ddp import wait_all

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


# the halo test's ops: a 3x3, the DLA-34 stem's 7x7, ResNet's 7x7 stride-2
# stem, the header's dilation-6 3x3, the KFPN's upsample, ResNet's max-pool
HALO_OPS = [("conv3", lambda: layers.Conv(8, 8, 3)), ("conv7", lambda: layers.Conv(3, 8, 7)),
            ("conv7_s2", lambda: layers.Conv(3, 8, 7, 2)), ("dil6", lambda: layers.Conv(8, 8, 3, 1, 6, bias=True)),
            ("upsample", lambda: layers.UpSample(8)), ("maxpool", lambda: layers.MaxPool(3, 2, 1))]
HALO_BANDS = [(0, 32), (32, 48)]  # uneven


def halo_inputs():
    """Seeded float64 ops, map and output gradients, on the CPU."""
    torch.manual_seed(0)
    gen = torch.Generator().manual_seed(1)
    out = {}
    for name, make in HALO_OPS:
        mod = make().double()
        if hasattr(mod, "reset_parameters"):
            mod.reset_parameters(gen)
        x = torch.randn(2, 3 if name.startswith("conv7") else 8, HALO_BANDS[-1][1], 40, dtype=torch.float64,
                        generator=gen)
        with torch.no_grad():
            gy = torch.randn(mod(x).shape, dtype=torch.float64, generator=gen)
        out[name] = (mod.state_dict(), x, gy)
    return out


def halo_op(name, state, x, gy, grid=None):
    """The op on the card: the output, the input gradient and the weight
    gradients, on the whole map or (with ``grid``) on this rank's band."""
    mod = dict(HALO_OPS)[name]().double().cuda()
    mod.load_state_dict(state)
    if grid is not None:
        a, b = grid.band
        scale = gy.shape[2] / x.shape[2]
        x, gy = x[:, :, a:b], gy[:, :, int(a * scale):int(b * scale)]
    x = x.cuda().requires_grad_()
    with spatial.attached(mod, grid):
        y = mod(x)
    (y * gy.cuda()).sum().backward()
    return {"y": y.detach().cpu(), "dx": x.grad.cpu(), "dw": [p.grad.cpu() for p in mod.parameters()]}


def _halo_rank(workdir: str, rank: int) -> None:
    """A rank of the halo test: every op on its band, over gloo on cuda:0."""
    dist.init_distributed("cuda:0", backend="gloo", init_method=f"file://{workdir}/store", rank=rank, world_size=2,
                          timeout=120)
    try:
        dist.init_mesh(1, 2)
        grid = spatial.Grid(HALO_BANDS, dist.spatial_index(), dist.spatial_group())
        spatial.halo_exchange.collectives = 0
        out = {name: halo_op(name, *args, grid=grid) for name, args in halo_inputs().items()}
        torch.cuda.synchronize()
        out["collectives"] = spatial.halo_exchange.collectives
        torch.save(out, os.path.join(workdir, f"halo{rank}.pt"))
    finally:
        dist.shutdown()


@pytest.mark.cuda
def test_halo_exchange_on_cuda_tensors_over_gloo(tmp_path):
    """The halo exchange's transport (an all_reduce over the spatial group)
    on CUDA tensors: two gloo ranks sharing the card, each on its band of
    uneven bands (32 + 16 rows), forward and backward through each banded
    op against the op on the whole map on the card, float64: within 1e-12
    of the largest value."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the transport is tested on CUDA tensors")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                                       os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, __file__, str(tmp_path), str(r)], env=env) for r in range(2)]
    wait_all(procs, 300)
    assert all(p.returncode == 0 for p in procs), [p.returncode for p in procs]
    ranks = [torch.load(tmp_path / f"halo{r}.pt", weights_only=False) for r in range(2)]
    assert ranks[0]["collectives"] == ranks[1]["collectives"] == 2 * len(HALO_OPS)  # forward and backward
    for name, args in halo_inputs().items():
        want = halo_op(name, *args)
        for key in ("y", "dx"):
            got = torch.cat([r[name][key] for r in ranks], 2)
            assert got.shape == want[key].shape, (name, key)
            assert (got - want[key]).abs().max() <= 1e-12 * want[key].abs().max(), (name, key)
        for i, w in enumerate(want["dw"]):
            got = ranks[0][name]["dw"][i] + ranks[1][name]["dw"][i]
            assert (got - w).abs().max() <= 1e-12 * w.abs().max(), (name, i)


if __name__ == "__main__":
    _halo_rank(sys.argv[1], int(sys.argv[2]))
