"""Tests of the port that need the card: the LM kernel against its plain
version, and the detect step on the GPU against the CPU.

This file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed. On a machine with a CUDA device, from the repository
root (``--noconftest`` skips tests/conftest.py, which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Without a device every test skips with its reason.
"""

import numpy as np
import pytest
import torch

from rtm3d_tpu_torch.config import default_config
from rtm3d_tpu_torch.decode.solve3d import COR, solve_bbox3d
from rtm3d_tpu_torch.nn.model import create_model
from rtm3d_tpu_torch.ops.lm_solver import lm_solve, lm_solve_reference
from rtm3d_tpu_torch.train.step import make_detect_step

pytestmark = pytest.mark.cuda
K_KITTI = np.array([[721.5, 0, 609.6], [0, 721.5, 172.9], [0, 0, 1.0]], np.float32)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the LM kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def lanes(rng, M, noise):
    """Projected car boxes + pixel noise in the kernel's layout, on the GPU."""
    d = np.array([1.53, 1.63, 3.88])  # h, w, l
    ry = rng.uniform(-np.pi, np.pi, (M, 1))
    loc = np.stack([rng.randn(M) * 3, rng.randn(M) * 0.3 + 1, rng.rand(M) * 25 + 8], -1)
    xc = COR[0] * d[2] * np.cos(ry) + COR[2] * d[1] * np.sin(ry) + loc[:, 0:1]
    yc = COR[1] * d[0] + loc[:, 1:2]
    zc = -COR[0] * d[2] * np.sin(ry) + COR[2] * d[1] * np.cos(ry) + loc[:, 2:3]
    u = K_KITTI[0, 0] * xc / zc + K_KITTI[0, 2]
    v = K_KITTI[1, 1] * yc / zc + K_KITTI[1, 2]
    uv = np.concatenate([u.T, v.T], 0) + rng.randn(16, M) * noise
    x0 = np.tile(np.array([0, 1, 3.884, 1.526, 1.629, 0, -0.5, 20.0])[:, None], (1, M))
    kp = np.tile(np.array([721.5, 721.5, 609.6, 172.9])[:, None], (1, M))
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda() for a in (uv, x0, kp)]


@pytest.mark.parametrize("prior_weight", [0.0, 20.0])
def test_lm_kernel_matches_reference(cuda, prior_weight):
    n = 2000
    uv, x0, kp = lanes(np.random.RandomState(5), n, noise=0.1)  # ~half accepted
    flipped = x0.clone()
    flipped[1] = -1.0  # the dual init: the same boxes from cos -1, as solve_bbox3d stacks them
    uv, x0, kp = torch.cat([uv, uv], 1), torch.cat([x0, flipped], 1), torch.cat([kp, kp], 1)
    before = lm_solve.launches
    xk, ck = lm_solve(uv, x0, kp, iters=40, prior_weight=prior_weight)
    torch.cuda.synchronize()
    assert lm_solve.launches == before + 1
    xr, cr = lm_solve_reference(uv, x0, kp, iters=40, prior_weight=prior_weight)
    ck, cr = ck.cpu().numpy()[0], cr.cpu().numpy()[0]
    assert np.isfinite(ck).all() and torch.isfinite(xk).all()
    if prior_weight == 0:
        # exact scale gauge: single lanes part on rounding alone (the JAX
        # package's own two versions part too), so hold the per-detection
        # decision over both inits, as the detect path gates
        ck, cr = ck.reshape(2, n).min(0), cr.reshape(2, n).min(0)
    # FMA contraction rounds differently from the plain version and a lane
    # can settle in another minimum: the accept decision (cost < 0.1) must
    # agree on >= 99.9%, and the cost within 1e-3 on >= 99.9% of what both
    # accept (chip_smoke.py holds the same bounds)
    assert 0.2 < (cr < 0.1).mean() < 0.8
    assert ((ck < 0.1) == (cr < 0.1)).mean() >= 0.999
    both = (ck < 0.1) & (cr < 0.1)
    assert (np.abs(ck - cr)[both] <= 1e-3).mean() >= 0.999


@pytest.mark.parametrize("M", [1, 127, 129, 300])
def test_lm_kernel_ragged_edge(cuda, M):
    """No pad lanes: every M works, and lane i's answer does not depend on
    how many lanes share the launch (the same lanes, cut from 300)."""
    uv, x0, kp = lanes(np.random.RandomState(6), 300, noise=0.2)
    x_all, c_all = lm_solve(uv, x0, kp, iters=20, prior_weight=20.0)
    x, c = lm_solve(*(t[:, :M].contiguous() for t in (uv, x0, kp)), iters=20, prior_weight=20.0)
    assert x.shape == (8, M) and c.shape == (1, M)
    assert torch.equal(x, x_all[:, :M]) and torch.equal(c, c_all[:, :M])


def test_lm_kernel_refuses_what_it_cannot_take(cuda):
    uv, x0, kp = lanes(np.random.RandomState(7), 64, noise=0.1)
    with pytest.raises(ValueError):
        lm_solve(uv.double(), x0, kp)
    with pytest.raises(ValueError):
        lm_solve(uv[:, ::2], x0[:, ::2], kp[:, ::2])  # not contiguous
    with pytest.raises(ValueError):
        lm_solve(uv, x0.cpu(), kp)
    before = lm_solve.launches
    x, c = lm_solve(uv[:, :0].contiguous(), x0[:, :0].contiguous(), kp[:, :0].contiguous())
    assert x.shape == (8, 0) and c.shape == (1, 0) and lm_solve.launches == before


def test_solve_bbox3d_on_gpu_matches_cpu(cuda):
    rng = np.random.RandomState(8)
    uv, _, _ = lanes(rng, 64, noise=0.03)
    v_proj = torch.stack([uv[:8].T, uv[8:].T], -1).reshape(4, 16, 8, 2)
    cls = torch.zeros((4, 16), dtype=torch.int32, device="cuda")
    K = torch.from_numpy(np.tile(K_KITTI, (4, 16, 1, 1))).cuda()
    dim_ref = default_config().DETECTOR.dim_ref
    before = lm_solve.launches
    got = solve_bbox3d(v_proj, cls, K, dim_ref, [0, -0.5, 20], iters=40, prior_weight=20.0)
    assert lm_solve.launches == before + 2  # the prior solve and the pure re-solve
    ref = solve_bbox3d(v_proj.cpu(), cls.cpu(), K.cpu(), dim_ref, [0, -0.5, 20], iters=40, prior_weight=20.0)
    acc_g, acc_r = (got["cost"].cpu() < 0.1), (ref["cost"] < 0.1)
    assert acc_r.float().mean() > 0.5 and (acc_g == acc_r).float().mean() >= 0.98
    both = acc_g & acc_r
    np.testing.assert_allclose(got["dim"].cpu()[both], ref["dim"][both], atol=0.01)
    np.testing.assert_allclose(got["loc"].cpu()[both], ref["loc"][both], atol=0.05)


def test_detect_step_gpu_matches_cpu(cuda):
    cfg = default_config()
    cfg.DETECTOR.TOPK_CANDIDATES = 10
    model = create_model(cfg, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(9)
    images = torch.from_numpy((rng.rand(2, 64, 96, 3) * 255).astype(np.uint8))
    K = torch.from_numpy(np.tile(np.array([[60.0, 0, 48], [0, 60, 32], [0, 0, 1]], np.float32), (2, 1, 1)))
    before = lm_solve.launches
    got = make_detect_step(model, cfg, device="cuda")(images, K)
    torch.cuda.synchronize()
    assert lm_solve.launches == before + 2
    ref = make_detect_step(model, cfg, device="cpu")(images, K)
    for k in ref:
        assert got[k].device.type == "cuda" and got[k].shape == ref[k].shape, k
    torch.testing.assert_close(got["scores"].cpu(), ref["scores"], atol=1e-4, rtol=1e-4)
    assert torch.equal(got["cls"].cpu(), ref["cls"]) and torch.equal(got["valid"].cpu(), ref["valid"])
    torch.testing.assert_close(got["v_proj"].cpu(), ref["v_proj"], atol=1e-2, rtol=1e-4)
