"""What the measurements of the port on a GPU share (``chip_smoke.py``):
the card's peak rates, the timers, the detect and train paths' shapes and
their synthetic inputs, and the LM kernel's agreement with its plain version.

It imports torch and numpy and nothing of this package, so a process that
imports another version of ``rtm3d_tpu_torch`` (``chip_smoke.py
--kernel-ab``) can keep it.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

FRAME_H, FRAME_W = 384, 1280
BATCH, TOPK, ITERS = 128, 100, 40  # the detect path: b128 x top-K 100, 40 LM iterations
TRAIN_BATCH, TRAIN_OBJS = 32, 64  # the train path: b32, MAX_OBJS 64
K_KITTI = np.array([[721.5, 0, 609.6], [0, 721.5, 172.9], [0, 0, 1.0]], np.float32)
# H100 SXM peaks (NVIDIA data sheet, 700 W): fp32 on the CUDA cores, HBM3,
# bf16 on the tensor cores
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
PEAK_BF16_FLOPS = 989e12  # dense, tensor cores


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def cuda_time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn()`` on the current stream, CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(fn, reps: int, kernel: str) -> float:
    """Mean device milliseconds of the kernels whose name holds ``kernel``
    over ``reps`` calls of ``fn()``, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if kernel in e.key and e.self_device_time_total > 0]
    if not rows:
        raise AssertionError(f"the profiler saw no {kernel} launch")
    return sum(e.self_device_time_total for e in rows) / sum(e.count for e in rows) / 1e3


def synthetic_lanes(rng, n_det: int, dim_ref):
    """KITTI-like boxes projected through K_KITTI with per-box pixel noise
    that straddles the acceptance threshold, laid out as the LM kernel takes
    them for three inits (cos +1, cos -1, a random yaw): uv (16, 3n),
    x0 (8, 3n), kp (4, 3n), on the card."""
    cor = np.array(
        [(i, j, k) for i in (1, -1) for j in (1, -1) for k in (1, -1)], np.float32
    ).T * 0.5
    cls = rng.randint(0, 3, n_det)
    d = dim_ref[cls] * rng.uniform(0.9, 1.1, (n_det, 3))  # h, w, l
    ry = rng.uniform(-np.pi, np.pi, n_det)[:, None]
    loc = np.stack(
        [rng.uniform(-15, 15, n_det), rng.uniform(0.5, 2.0, n_det), rng.uniform(6, 60, n_det)], -1
    )
    xc = cor[0] * d[:, 2:3] * np.cos(ry) + cor[2] * d[:, 1:2] * np.sin(ry) + loc[:, 0:1]
    yc = cor[1] * d[:, 0:1] + loc[:, 1:2]
    zc = -cor[0] * d[:, 2:3] * np.sin(ry) + cor[2] * d[:, 1:2] * np.cos(ry) + loc[:, 2:3]
    u = K_KITTI[0, 0] * xc / zc + K_KITTI[0, 2]
    v = K_KITTI[1, 1] * yc / zc + K_KITTI[1, 2]
    uv = np.concatenate([u.T, v.T], 0)  # (16, n)
    uv += rng.randn(*uv.shape) * rng.uniform(0.01, 0.2, n_det)
    prior = dim_ref[cls]
    yaw0 = rng.uniform(-np.pi, np.pi, n_det)
    inits = []
    for s, c in ((0.0, 1.0), (0.0, -1.0), (np.sin(yaw0), np.cos(yaw0))):
        x0 = np.zeros((8, n_det))
        x0[0], x0[1] = s, c
        x0[2], x0[3], x0[4] = prior[:, 2], prior[:, 0], prior[:, 1]  # l, h, w
        x0[5:8] = np.array([0.0, -0.5, 20.0])[:, None]
        inits.append(x0)
    kp = np.tile(np.array([K_KITTI[0, 0], K_KITTI[1, 1], K_KITTI[0, 2], K_KITTI[1, 2]])[:, None], (1, n_det))
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()
    return f32(np.tile(uv, (1, 3))), f32(np.concatenate(inits, 1)), f32(np.tile(kp, (1, 3)))


def lm_agreement(a, b):
    """Two LM cost vectors (numpy): the share of equal accept decisions
    (cost < 0.1), and where both accept, the share within 1e-3 and the
    largest difference."""
    both = (a < 0.1) & (b < 0.1)
    diff = np.abs(a - b)[both]
    return (float(((a < 0.1) == (b < 0.1)).mean()),
            float((diff <= 1e-3).mean()) if both.any() else 1.0,
            float(diff.max()) if both.any() else 0.0)


def synthetic_labels(rng, B: int, N: int, scale: float = 1.0) -> dict:
    """Label blocks as tools/bench_train.py:31-60 makes them at 1280x384 (90x55
    px boxes, a KITTI K), scaled by ``scale``, with about a quarter of the
    slots masked out and a tenth of the live ones flagged as noise."""
    w, h = FRAME_W * scale, FRAME_H * scale
    x1 = rng.rand(B, N) * (w - 100 * scale)
    y1 = rng.rand(B, N) * (h - 60 * scale)
    K = np.array([721.5, 0, 609.6, 0, 721.5, 172.9, 0, 0, 1], np.float32)
    K[:6] *= scale
    mask = rng.rand(B, N) > 0.25
    return {
        "cls": torch.from_numpy(rng.randint(0, 3, (B, N)).astype(np.int32)),
        "bbox": torch.from_numpy(np.stack([x1, y1, x1 + 90 * scale, y1 + 55 * scale], -1).astype(np.float32)),
        "dim": torch.from_numpy((rng.rand(B, N, 3) + 0.8).astype(np.float32)),
        "alpha": torch.zeros((B, N)),
        "ry": torch.from_numpy(rng.uniform(-3, 3, (B, N)).astype(np.float32)),
        "loc": torch.from_numpy(np.stack(
            [rng.randn(B, N) * 5, rng.randn(B, N) * 0.3 + 1.2, rng.rand(B, N) * 40 + 6], -1).astype(np.float32)),
        "K": torch.from_numpy(np.tile(K, (B, N, 1))),
        "mask": torch.from_numpy(mask),
        "noise_mask": torch.from_numpy(mask & (rng.rand(B, N) < 0.1)),
    }


def splat_edge_inputs(B: int, N: int, feat_hw):
    """Edge cases at the training map size: image 0 all masked; image 1
    centers off the map whose windows reach in; image 2 R = 0 slots, half of
    them noise; image 3 two classes on the same centers, one noise."""
    Hf, Wf = feat_hw
    rng = np.random.RandomState(11)
    m_proj = np.stack([rng.randint(0, Wf, (B, N)), rng.randint(0, Hf, (B, N))], -1)
    sigma = rng.rand(B, N) * 4 + 0.5
    radius = np.ceil(sigma * 3)
    cls = rng.randint(0, 3, (B, N))
    mask = np.ones((B, N), bool)
    noise = np.zeros((B, N), bool)
    mask[0] = False
    m_proj[1, :, 0] = np.where(np.arange(N) % 2 == 0, -rng.randint(1, 8, N), Wf + rng.randint(0, 8, N))
    radius[2] = 0.0
    noise[2, ::2] = True
    m_proj[3, 1::2] = m_proj[3, ::2]
    cls[3, ::2], cls[3, 1::2] = 0, 1
    noise[3, 1::4] = True
    return [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in (
        m_proj.astype(np.int32), cls.astype(np.int32), sigma.astype(np.float32),
        radius.astype(np.float32), mask, noise)]
