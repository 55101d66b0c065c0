"""Tests of the port that need the card: the LM, splat, KFPN fusion and
DCN kernels against their plain versions, and the detect and train steps on the
GPU against the CPU; plus, on the CPU, that the entry points refuse to run
without a GPU unless asked for the CPU.

This file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed. On a machine with a CUDA device, from the repository
root (``--noconftest`` skips tests/conftest.py, which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Without a device every ``cuda``-marked test skips with its reason.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rtm3d_tpu_torch.api import Detector
from rtm3d_tpu_torch.config import default_config
from rtm3d_tpu_torch.decode.solve3d import COR, solve_bbox3d
from rtm3d_tpu_torch.nn.kfpn import KeypointFPNFusion
from rtm3d_tpu_torch.nn.model import create_model
from rtm3d_tpu_torch.nn.spec import ShapeSpec
from rtm3d_tpu_torch.ops.dcn import dcn_reference, modulated_deform_conv
from rtm3d_tpu_torch.ops.kfpn_fuse import kfpn_fuse, kfpn_fuse_reference
from rtm3d_tpu_torch.ops.lm_solver import lm_solve, lm_solve_reference
from rtm3d_tpu_torch.ops.splat import splat_heatmap, splat_heatmap_reference
from rtm3d_tpu_torch.train.state import TrainState
from rtm3d_tpu_torch.train.step import make_detect_step, make_eval_loss_step, make_train_step
from rtm3d_tpu_torch.utils import profiling

K_KITTI = np.array([[721.5, 0, 609.6], [0, 721.5, 172.9], [0, 0, 1.0]], np.float32)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
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


@pytest.mark.cuda
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


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 2, 3, 31, 33, 65, 127, 129, 300, 1001])
def test_lm_kernel_ragged_edge(cuda, M):
    """No pad lanes: every M works, a multiple of a warp or not, and lane
    i's answer does not depend on how many lanes share the launch or on the
    grid lm_launch_geometry picks for them (the same lanes, cut from 1,024)."""
    uv, x0, kp = lanes(np.random.RandomState(6), 1024, noise=0.2)
    x_all, c_all = lm_solve(uv, x0, kp, iters=20, prior_weight=20.0)
    x, c = lm_solve(*(t[:, :M].contiguous() for t in (uv, x0, kp)), iters=20, prior_weight=20.0)
    assert x.shape == (8, M) and c.shape == (1, M)
    assert torch.equal(x, x_all[:, :M]) and torch.equal(c, c_all[:, :M])


@pytest.mark.cuda
def test_lm_kernel_keeps_a_bad_detection_to_itself(cuda):
    """A detection whose targets are NaN, and one whose box starts with a
    corner at z = 0, change no other detection's answer."""
    M = 96
    uv, x0, kp = lanes(np.random.RandomState(M), M, noise=0.1)
    clean = lm_solve(uv, x0, kp, iters=40, prior_weight=20.0)
    bad_uv, bad_x0 = uv.clone(), x0.clone()
    bad_uv[:, 5] = float("nan")
    # sin 0, cos 1: the corners with z sign +1/2 sit at depth w/2 + Z + 1e-4 = 0
    bad_x0[7, 9] = -(0.5 * bad_x0[4, 9] + 1e-4)
    bad = lm_solve(bad_uv, bad_x0, kp, iters=40, prior_weight=20.0)
    torch.cuda.synchronize()
    keep = torch.ones(M, dtype=torch.bool, device="cuda")
    keep[[5, 9]] = False
    assert torch.equal(bad[0][:, keep], clean[0][:, keep]) and torch.equal(bad[1][:, keep], clean[1][:, keep])


@pytest.mark.cuda
def test_kernels_are_deterministic(cuda):
    uv, x0, kp = lanes(np.random.RandomState(8), 4096, noise=0.1)
    runs = [lm_solve(uv, x0, kp, iters=40, prior_weight=20.0) for _ in range(3)]
    assert all(torch.equal(r[0], runs[0][0]) and torch.equal(r[1], runs[0][1]) for r in runs)
    args = splat_inputs(np.random.RandomState(3), 32, 64, 96, 320)
    maps = [splat_heatmap(*args, (96, 320), 3) for _ in range(3)]
    assert all(torch.equal(m, maps[0]) for m in maps)


@pytest.mark.cuda
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


@pytest.mark.cuda
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


@pytest.mark.cuda
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


def splat_inputs(rng, B, N, H, W, C=3, device="cuda"):
    """tests/test_pallas_ops.py:11-20's generator at any size: centers in
    [-4, W+4), a quarter of the slots masked out, noise slots."""
    m_proj = np.stack([rng.randint(-4, W + 4, (B, N)), rng.randint(-4, H + 4, (B, N))], -1)
    sigma = rng.rand(B, N) * 4 + 0.5
    mask = rng.rand(B, N) > 0.25
    arrays = (m_proj.astype(np.int32), rng.randint(0, C, (B, N)).astype(np.int32),
              sigma.astype(np.float32), np.ceil(sigma * 3).astype(np.float32), mask,
              (rng.rand(B, N) > 0.7) & mask)
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 8, 32, 40), (32, 64, 96, 320), (3, 70, 17, 33), (1, 64, 96, 320),
                                   (2, 16, 20, 42), (2, 300, 9, 130)])
def test_splat_kernel_matches_reference(cuda, shape):
    """Exact but for the ulp of expf: max |d| <= 1e-6, and the pixels equal
    to 1.0 (the focal loss's positives) identical. (3, 70, 17, 33) and
    (2, 16, 20, 42): ragged tile edges, and widths whose rows are not
    16-byte aligned (one float a store); (1, 64, 96, 320): one image;
    (2, 300, 9, 130): more slots than one staged chunk."""
    B, N, H, W = shape
    args = splat_inputs(np.random.RandomState(sum(shape)), B, N, H, W)
    before = splat_heatmap.launches
    got = splat_heatmap(*args, (H, W), 3)
    torch.cuda.synchronize()
    assert splat_heatmap.launches == before + 1 and got.shape == (B, 3, H, W)
    ref = splat_heatmap_reference(*args, (H, W), 3)
    assert (got - ref).abs().max().item() <= 1e-6
    assert torch.equal(got == 1.0, ref == 1.0)
    assert torch.equal(got, splat_heatmap(*args, (H, W), 3))  # deterministic


@pytest.mark.cuda
def test_splat_kernel_takes_centers_off_an_8_byte_boundary(cuda):
    """m_proj as a contiguous view 4 bytes into its storage: the centers
    cannot be read 8 bytes at a time there."""
    B, N, H, W = 2, 16, 24, 80
    args = splat_inputs(np.random.RandomState(6), B, N, H, W)
    buf = torch.empty(B * N * 2 + 1, dtype=torch.int32, device="cuda")
    buf[1:] = args[0].flatten()
    shifted = buf[1:].view(B, N, 2)
    assert shifted.is_contiguous() and shifted.data_ptr() % 8 == 4
    got = splat_heatmap(shifted, *args[1:], (H, W), 3)
    assert torch.equal(got, splat_heatmap(*args, (H, W), 3))
    assert (got - splat_heatmap_reference(*args, (H, W), 3)).abs().max().item() <= 1e-6


@pytest.mark.cuda
def test_splat_kernel_many_slots_in_one_tile(cuda):
    """130 slots, all centred in the first tile of image 0 (more than a
    block stages at once), the rest of the batch as usual."""
    B, N, H, W = 2, 130, 24, 80
    args = splat_inputs(np.random.RandomState(4), B, N, H, W, device="cpu")
    rng = np.random.RandomState(5)
    args[0][0, :, 0] = torch.from_numpy(rng.randint(0, 64, N).astype(np.int32))
    args[0][0, :, 1] = torch.from_numpy(rng.randint(0, 8, N).astype(np.int32))
    args[4][0] = True
    args = [a.cuda() for a in args]
    got = splat_heatmap(*args, (H, W), 3)
    ref = splat_heatmap_reference(*args, (H, W), 3)
    assert (got - ref).abs().max().item() <= 1e-6
    assert torch.equal(got == 1.0, ref == 1.0)


@pytest.mark.cuda
def test_splat_kernel_refuses_what_it_cannot_take(cuda):
    args = splat_inputs(np.random.RandomState(1), 2, 8, 16, 16)
    with pytest.raises(ValueError):
        splat_heatmap(args[0].long(), *args[1:], (16, 16), 3)
    with pytest.raises(ValueError):
        splat_heatmap(*args[:2], args[2].cpu(), *args[3:], (16, 16), 3)
    with pytest.raises(ValueError):
        splat_heatmap(*args, (16, 16), 9)  # more classes than the kernel holds


def train_batch(rng, B=2, N=8):
    """A batch of uint8 96x64 frames and N label slots an image."""
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
    return {"image": (rng.rand(B, 64, 96, 3) * 255).astype(np.uint8), "labels": labels}


@pytest.mark.cuda
def test_train_step_gpu_matches_cpu(cuda):
    cfg = default_config()
    cfg.INPUT_SIZE = (96, 64)
    cfg.DATASET.MAX_OBJS = 8
    model = create_model(cfg, torch.Generator().manual_seed(0))
    batch = train_batch(np.random.RandomState(2))
    out = {}
    for dev in ("cuda", "cpu"):
        state = TrainState.create(model, cfg, device=dev, with_ema=True)
        before = splat_heatmap.launches
        state, m = make_train_step(cfg, device=dev)(state, batch)
        ev = make_eval_loss_step(cfg, device=dev)(state, batch)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert splat_heatmap.launches == before + 2  # the train step and the eval step
        out[dev] = (m["loss_items"].cpu(), ev["loss_items"].cpu(),
                    torch.cat([p.grad.flatten().cpu() for p in state.model.parameters()]))
    (ag, eg, gg), (ac, ec, gc) = out["cuda"], out["cpu"]
    torch.testing.assert_close(ag, ac, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(eg, ec, rtol=1e-3, atol=1e-6)  # after an update of Adamax's sign steps
    # float32 noise: this network's gradient at random init is noisy at the
    # 1% level (chip_smoke.py's train_fp32 phase)
    assert ((gg - gc).norm() / gc.norm()).item() <= 5e-2


def fusion_maps(batch, hw=(104, 320)):
    """x0 and three upsampled maps as the detect path holds them at 1280x416
    (256 channels at stride 4, channels_last, bf16); the upsampled maps at
    three times x0's spread, so that the softmax weights are peaked."""
    g = torch.Generator(device="cuda").manual_seed(0)
    maps = [torch.randn((batch, *hw, 256), generator=g, device="cuda").mul_(3.0 if i else 1.0)
            .bfloat16().permute(0, 3, 1, 2) for i in range(4)]
    return maps[0], maps[1:]


def composed_fusion(x0, ups):
    """The KFPN's composed loop (nn/kfpn.py), in the maps' dtype."""
    z = x0
    for u in ups:
        b, c, h, w = u.shape
        z = z + u * torch.softmax(u.reshape(b, c, h * w), -1).reshape(b, c, h, w)
    return z


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [32, 1])
def test_kfpn_fuse_kernel_at_the_detect_paths_maps(cuda, batch):
    """At b32 and b1 x 256 x 104 x 320 in bf16: the kernel's error against
    the float64 fusion no larger than PyTorch's bf16 composition's, in its
    largest and its mean; z channels_last; two runs bit-equal; two
    launches."""
    x0, ups = fusion_maps(batch)
    before = kfpn_fuse.launches
    z = kfpn_fuse(x0, ups)
    torch.cuda.synchronize()
    assert kfpn_fuse.launches == before + 2
    assert z.shape == x0.shape and z.dtype == torch.bfloat16
    assert z.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(z, kfpn_fuse(x0, ups))
    exact = kfpn_fuse_reference(x0.double(), [u.double() for u in ups])
    err = (z.double() - exact).abs()
    plain = (composed_fusion(x0, ups).double() - exact).abs()
    assert err.max() <= plain.max() and err.mean() <= plain.mean()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kfpn_fuse_kernel_in_other_dtypes_and_shapes(cuda, dtype):
    """fp32 and bf16 maps (the detect step's two compute dtypes); 1 and 4
    upsampled maps, a channel count other than 256 and a map whose pixels
    split unevenly over the blocks."""
    for n_ups, C, hw in ((1, 24, (7, 9)), (4, 64, (13, 37))):
        g = torch.Generator(device="cuda").manual_seed(C)
        maps = [torch.randn((2, *hw, C), generator=g, device="cuda").mul_(2.0).to(dtype).permute(0, 3, 1, 2)
                for _ in range(n_ups + 1)]
        z = kfpn_fuse(maps[0], maps[1:])
        exact = kfpn_fuse_reference(maps[0].double(), [u.double() for u in maps[1:]])
        tol = 1e-5 if dtype == torch.float32 else 2 ** -8  # bf16: half an ulp, rounded once
        assert ((z.double() - exact).abs() <= tol * (1 + exact.abs())).all()


@pytest.mark.cuda
def test_kfpn_fuse_kernel_on_maps_of_a_trained_networks_magnitude(cuda):
    """fp32 upsampled maps whose values reach 1e4, as a trained network's
    do: each weight's exponent takes the difference from the channel's max
    first, so the error against the float64 fusion stays at float32's
    (PyTorch's composition: 9e-8 of the largest value on the H100; a shift
    folded into one float, log2e * max + log2 sum, gave 6e-4)."""
    g = torch.Generator(device="cuda").manual_seed(3)
    maps = [torch.randn((2, 48, 64, 256), generator=g, device="cuda").mul_(3000.0 if i else 1.0).permute(0, 3, 1, 2)
            for i in range(4)]
    z = kfpn_fuse(maps[0], maps[1:])
    exact = kfpn_fuse_reference(maps[0].double(), [u.double() for u in maps[1:]])
    assert (z.double() - exact).abs().max() <= 1e-6 * exact.abs().max()


@pytest.mark.cuda
def test_kfpn_fuse_kernel_refuses_what_it_cannot_take(cuda):
    x0, ups = fusion_maps(1, hw=(8, 8))
    with pytest.raises(ValueError, match="channels_last"):
        kfpn_fuse(x0, [ups[0].contiguous(), *ups[1:]])
    with pytest.raises(ValueError, match="one device"):
        kfpn_fuse(x0, [ups[0].cpu(), *ups[1:]])
    with pytest.raises(ValueError, match="one dtype"):
        kfpn_fuse(x0.float(), ups)


@pytest.mark.cuda
@pytest.mark.parametrize("fault,match", [("nchw", "channels_last"), ("channels", "multiple of 8")])
def test_kfpn_forward_raises_on_maps_the_kernel_does_not_take(cuda, fault, match):
    """A CUDA forward with autograd and autocast off takes the kernel and
    raises on NCHW maps or a channel count not a multiple of 8: there is
    no composed fallback on the card."""
    names = ["l0", "l1", "l2"]
    spec = {n: ShapeSpec(channels=c, stride=4 * 2 ** i) for i, (n, c) in enumerate(zip(names, [16, 24, 32]))}
    module = KeypointFPNFusion(names, spec, out_channels=12 if fault == "channels" else 16).cuda().eval()
    feats = [torch.randn(2, c, 3 * 2 ** (2 - i), 5 * 2 ** (2 - i), device="cuda") for i, c in enumerate([16, 24, 32])]
    if fault == "channels":
        module = module.to(memory_format=torch.channels_last)
        feats = [f.contiguous(memory_format=torch.channels_last) for f in feats]
    before = kfpn_fuse.launches
    with torch.inference_mode(), pytest.raises(ValueError, match=match):
        module(feats)
    assert kfpn_fuse.launches == before


def small_cfg(dtype: str):
    cfg = default_config()
    cfg.MODEL.BACKBONE = "RESNET-18"
    cfg.MODEL.KFNs = ["layer1", "layer2", "layer3", "layer4"]
    cfg.INPUT_SIZE = (96, 64)
    cfg.DATASET.MAX_OBJS = 8
    cfg.TPU.COMPUTE_DTYPE = dtype
    return cfg


@pytest.mark.cuda
def test_detect_call_fuses_with_no_host_sync_of_its_own(cuda):
    """Traced ``Detector`` calls of uint8 frames in bf16 take the fused
    path (two launches and one ``kfpn_fused`` a call) and wait for the
    device 15 times a call, as the composed path does
    (tests/test_torch_spans.py): the counter, and the trace's stream
    synchronisations (two calls' less one call's, so that what the
    profiler itself adds cancels)."""
    cfg = small_cfg("bfloat16")
    detector = Detector(cfg, create_model(cfg, torch.Generator().manual_seed(0)), device="cuda")
    rng = np.random.RandomState(4)
    frames = rng.randint(0, 256, (2, 64, 96, 3)).astype(np.uint8)
    K = np.tile(np.array([[60.0, 0, 48], [0, 60, 32], [0, 0, 1]], np.float32), (2, 1, 1))
    detector(frames, K)  # builds the kernels

    def syncs(calls):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                detector(frames, K)
        return sum(e.count for e in prof.key_averages() if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize"))

    launches, counted = kfpn_fuse.launches, dict(profiling.counters)
    per_call = syncs(2) - syncs(1)
    moved = {k: v - counted.get(k, 0) for k, v in profiling.counters.items() if v != counted.get(k, 0)}
    assert kfpn_fuse.launches == launches + 3 * 2
    assert moved == {"host_syncs": 3 * 15, "kfpn_fused": 3}
    assert per_call == 15


@pytest.mark.cuda
def test_train_and_eval_loss_steps_compose_the_fusion(cuda):
    """Under bf16 autocast with autograd the KFPN composes: no launch of
    the fusion kernel in a train step or an eval-loss step."""
    cfg = small_cfg("bfloat16")
    state = TrainState.create(create_model(cfg, torch.Generator().manual_seed(0)), cfg, device="cuda")
    batch = train_batch(np.random.RandomState(6))
    before = kfpn_fuse.launches
    state, m = make_train_step(cfg, device="cuda")(state, batch)
    ev = make_eval_loss_step(cfg, device="cuda")(state, batch)
    torch.cuda.synchronize()
    assert kfpn_fuse.launches == before
    assert torch.isfinite(m["loss_items"]).all() and torch.isfinite(ev["loss_items"]).all()


def dcn_inputs(batch, channels, hw, dtype, offsets, seed=0):
    """x, the offset conv's output and a 3x3 weight as the detect path holds
    them (channels_last), xavier-bounded weights; offsets at the benchmark
    init's scale (normal, 0.1 px) or uniform in +-4 px (a trained layer's
    reach: samples beyond every border), mask logits standard normal."""
    H, W = hw
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((batch, H, W, channels), generator=g, device="cuda")
    om = torch.randn((batch, H, W, 27), generator=g, device="cuda")
    if offsets == "4px":
        om[..., :18] = torch.rand((batch, H, W, 18), generator=g, device="cuda") * 8 - 4
    else:
        om[..., :18] *= 0.1
    bound = (6.0 / (2 * 9 * channels)) ** 0.5
    w = (torch.rand((channels, 3, 3, channels), generator=g, device="cuda") * 2 - 1) * bound
    return [t.to(dtype).permute(0, 3, 1, 2) for t in (x, om, w)]


@pytest.mark.cuda
@pytest.mark.parametrize("offsets", ["init", "4px"])
@pytest.mark.parametrize("channels,hw", [(256, (26, 80)), (512, (13, 40))], ids=["layer3", "layer4"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dcn_kernel_at_the_published_widths(cuda, dtype, channels, hw, offsets):
    """ResNet-101-DCN's layer3 and layer4 convs at 1280x416, B 8. bf16:
    the kernel rounds the same fp32 taps and accumulates the same products
    in fp32 as the plain version, so each output is within one bf16 ulp of
    it (2**-7 of its magnitude bounds an ulp), give or take a tap that
    rounds the other way (the kernel sums a tap's four corners with fused
    multiply-adds): a weight times a tap's ulp, under 2e-3 of the largest
    output on these inputs. The mean gap stays under 1e-5 of the largest
    output (4e-7 to 9e-7 on the H100; accumulating in bf16 reads ~1e-2).
    fp32: against the float64 plain version within 5e-5 of the largest
    output (fp32 sums read 4e-6 on the H100, 14x under; bf16 products read
    4e-3 to 1e-2, 80x over). z channels_last, two runs bit-equal, one
    launch."""
    x, om, w = dcn_inputs(8, channels, hw, dtype, offsets)
    before = modulated_deform_conv.launches
    y = modulated_deform_conv(x, om, w)
    torch.cuda.synchronize()
    assert modulated_deform_conv.launches == before + 1
    assert y.shape == x.shape and y.dtype == dtype and y.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(y, modulated_deform_conv(x, om, w))
    if dtype == torch.bfloat16:
        p = dcn_reference(x, om, w).double()
        gap = (y.double() - p).abs()
        top = p.abs().max()
        assert (gap <= 2 ** -7 * p.abs() + 2e-3 * top).all(), float(gap.max())
        assert gap.mean() <= 1e-5 * top, float(gap.mean())
    else:
        exact = dcn_reference(x.double(), om.double(), w.double())
        assert (y.double() - exact).abs().max() <= 5e-5 * exact.abs().max()


@pytest.mark.cuda
def test_dcn_kernel_refuses_what_it_cannot_take(cuda):
    x, om, w = dcn_inputs(1, 256, (6, 8), torch.bfloat16, "init")
    for args, match in (((x.contiguous(), om, w), "channels_last"), ((x, om.float(), w), "one dtype"),
                        ((x.half(), om.half(), w.half()), "one dtype"), ((x, om[:, :18], w), "offsets of shape"),
                        ((x, om, w.cpu()), "one device"), ((x, om, w[:64]), "multiple of 128"),
                        ((x[:, :48], om, w[:, :48]), "multiple of 32")):
        before = modulated_deform_conv.launches
        with pytest.raises(ValueError, match=match):
            modulated_deform_conv(*args)
        assert modulated_deform_conv.launches == before


def dcn_cfg(dtype: str):
    cfg = small_cfg(dtype)
    cfg.MODEL.BACKBONE = "RESNET-101-DCN"
    return cfg


@pytest.mark.cuda
def test_dcn_detect_runs_the_kernel_in_all_26_layers(cuda):
    """A ResNet-101-DCN ``Detector`` in bf16 launches the kernel in each of
    its 26 deformable layers a call and counts them (``dcn_kernel``), with
    15 host syncs a call as every detect call; a train step composes
    them (no launch) and leaves every parameter finite."""
    cfg = dcn_cfg("bfloat16")
    model = create_model(cfg, torch.Generator().manual_seed(0))
    detector = Detector(cfg, model, device="cuda")
    rng = np.random.RandomState(4)
    frames = rng.randint(0, 256, (2, 64, 96, 3)).astype(np.uint8)
    K = np.tile(np.array([[60.0, 0, 48], [0, 60, 32], [0, 0, 1]], np.float32), (2, 1, 1))
    detector(frames, K)
    launches, counted = modulated_deform_conv.launches, dict(profiling.counters)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(2):
            detector(frames, K)
    moved = {k: v - counted.get(k, 0) for k, v in profiling.counters.items() if v != counted.get(k, 0)}
    assert modulated_deform_conv.launches == launches + 2 * 26
    assert moved == {"host_syncs": 2 * 15, "kfpn_fused": 2, "dcn_kernel": 2 * 26}
    state = TrainState.create(create_model(cfg, torch.Generator().manual_seed(0)), cfg, device="cuda")
    before = modulated_deform_conv.launches
    state, m = make_train_step(cfg, device="cuda")(state, train_batch(np.random.RandomState(6)))
    torch.cuda.synchronize()
    assert modulated_deform_conv.launches == before and torch.isfinite(m["loss_items"]).all()
    assert all(torch.isfinite(p).all() for p in state.model.parameters())


@pytest.mark.cuda
def test_dcn_network_kernel_matches_composed_cpu(cuda):
    """The fp32 ResNet-101-DCN network at 128x64, its 26 layers on the
    kernel on the card (TF32 off), against the composed network on the
    CPU: the logits within 1e-4 of the largest, as the fp32 DLA-34 is
    held card against CPU (chip_smoke.py's logits phase)."""
    cfg = dcn_cfg("float32")
    model = create_model(cfg, torch.Generator().manual_seed(1)).eval()
    x = torch.randn(2, 3, 64, 128, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = model(x)
    net = model.cuda().to(memory_format=torch.channels_last)
    before = modulated_deform_conv.launches
    with torch.inference_mode():
        got = net(x.cuda().contiguous(memory_format=torch.channels_last))
    assert modulated_deform_conv.launches == before + 26
    for a, b in zip(got, want):
        assert (a.cpu() - b).abs().max() <= 1e-4 * b.abs().max()


def test_train_entry_points_raise_without_gpu(monkeypatch):
    cfg = default_config()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (make_train_step, make_eval_loss_step):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(cfg)
        assert callable(make(cfg, device="cpu"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrainState.create(create_model(cfg), cfg)
