#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (rtm3d_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py    # from the repository root

Phases, one JSON line each; any failure exits non-zero:
  device   the card (nvidia-smi name and power limit), torch and CUDA versions;
  build    compiles rtm3d_tpu_torch/csrc/*.cu (nvcc, one process per source);
  lm_*     the LM kernel against its plain PyTorch version on the card at
           the detect path's lane counts (M = 25,600 and 38,400 for batch
           128 x top-K 100, the second call's third init being the first
           call's solution), accept-mask agreement >= 99.9% and, where both
           accept, cost within 1e-3 on >= 99.9% (per lane at the prior, per
           detection without it), CUDA-event times and the fp32 bound;
  logits   full-width DLA-34 1280x384 fp32 forward, port on the GPU against
           the port on the CPU (TF32 off), max |d| <= 1e-4 of max |logit|;
  serve    DLA-34 1280x384 batch 128 bf16 detect through Detector, distinct
           uint8 frames per call, a KITTI K: exactly 2 LM launches per call,
           finite outputs of the right shapes, images/s from CUDA events;
  profile  torch.profiler over two serving calls: device time by kernel,
           idle share; the full table goes to chip_smoke_out/serve_profile.json.
Then the kernels line, the nvidia-smi line and, last, {"ok": true, ...}.
Needs one CUDA device; without one it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

H, W = 384, 1280
BATCH, TOPK, ITERS = 128, 100, 40
SERVE_CALLS = 6
K_KITTI = np.array([[721.5, 0, 609.6], [0, 721.5, 172.9], [0, 0, 1.0]], np.float32)
# H100 SXM peaks (NVIDIA data sheet, 700 W): fp32 on the CUDA cores, HBM3,
# bf16 on the tensor cores
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
PEAK_BF16_FLOPS = 989e12  # dense, tensor cores
LM_REPLACES = "rtm3d_tpu/ops/lm_solver.py:35"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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


def synthetic_lanes(rng, n_det: int, dim_ref):
    """KITTI-like boxes projected through K_KITTI with per-box pixel noise
    that straddles the acceptance threshold, laid out as the LM kernel takes
    them for three inits (cos +1, cos -1, a random yaw): uv (16, 3n),
    x0 (8, 3n), kp (4, 3n)."""
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


def lm_phase(lm, uv, x0, kp, n_det: int, prior_weight: float) -> dict:
    """Kernel against plain version on the same lanes: ``n_det`` detections
    times the inits stacked along the lane axis, as solve_bbox3d lays them."""
    m = uv.shape[1]
    xk, ck = lm.lm_solve(uv, x0, kp, iters=ITERS, prior_weight=prior_weight)
    torch.cuda.synchronize()
    xr, cr = lm.lm_solve_reference(uv, x0, kp, iters=ITERS, prior_weight=prior_weight)
    ck, cr = ck[0].cpu().numpy(), cr[0].cpu().numpy()
    if not (np.isfinite(ck).all() and np.isfinite(xk.cpu().numpy()).all()):
        raise AssertionError(f"LM kernel: non-finite output at M={m}")

    def agreement(a, b):
        both = (a < 0.1) & (b < 0.1)
        diff = np.abs(a - b)[both]
        return (float(((a < 0.1) == (b < 0.1)).mean()),
                float((diff <= 1e-3).mean()) if both.any() else 1.0,
                float(diff.max()) if both.any() else 0.0)

    lane = agreement(ck, cr)
    # what the detect path gates on: per detection, the least cost over its inits
    det = agreement(ck.reshape(-1, n_det).min(0), cr.reshape(-1, n_det).min(0))
    kernel_ms = cuda_time_ms(lambda: lm.lm_solve(uv, x0, kp, iters=ITERS, prior_weight=prior_weight), 20, 2)
    plain_ms = cuda_time_ms(lambda: lm.lm_solve_reference(uv, x0, kp, iters=ITERS, prior_weight=prior_weight), 3)
    flops, nbytes = lm.lm_flops(m, ITERS, prior_weight), lm.lm_bytes(m)
    bound_ms = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    rec = {
        "M": m, "detections": n_det, "prior_weight": prior_weight,
        "lane_accept_agreement": lane[0], "lane_cost_within_1e-3": lane[1],
        "lane_max_abs_cost_diff_accepted": lane[2],
        "detection_accept_agreement": det[0], "detection_cost_within_1e-3": det[1],
        "detection_max_abs_cost_diff_accepted": det[2],
        "accepted_frac": float((cr < 0.1).mean()),
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "flops": flops, "bytes": nbytes,
        "bound_ms": bound_ms, "bound_by": "operations" if flops / PEAK_FP32_FLOPS > nbytes / PEAK_BYTES else "bytes",
    }
    emit(f"lm_M{m}_prior{prior_weight:g}", **rec)
    # FMA contraction rounds differently from the plain version, and a lane
    # now and then settles in another minimum: the accept decision must agree
    # on >= 99.9%, and the cost within 1e-3 on >= 99.9% of what both accept.
    # With the prior the problem is well posed and each lane is held to it.
    # Without it the objective has an exact scale gauge and lanes part on
    # rounding alone (the JAX package's own two versions part too), so the
    # per-detection decision is held to it.
    held = lane if prior_weight > 0 else det
    if held[0] < 0.999 or held[1] < 0.999:
        raise AssertionError(f"LM kernel disagrees with its plain version: {rec}")
    rec["x"], rec["cost"] = xk, ck
    return rec


def logits_phase(cfg_base, nn_model) -> None:
    import copy

    from rtm3d_tpu_torch.decode.peaks import decode_detections
    from rtm3d_tpu_torch.train.step import normalize_images

    cfg = cfg_base.clone()
    cfg.TPU.COMPUTE_DTYPE = "float32"
    model = nn_model.create_model(cfg, torch.Generator().manual_seed(0)).eval()
    img = torch.from_numpy((np.random.RandomState(1).rand(1, H, W, 3) * 255).astype(np.uint8))
    x = normalize_images(img, cfg).permute(0, 3, 1, 2)
    gpu = copy.deepcopy(model).cuda().to(memory_format=torch.channels_last)
    with torch.inference_mode():
        t0 = time.perf_counter()
        ref = model(x)
        cpu_s = time.perf_counter() - t0
        got = gpu(x.cuda())
        torch.cuda.synchronize()
        d_ref = decode_detections(ref, topk=TOPK)
        d_got = decode_detections(got, topk=TOPK)
    rec, worst = {"cpu_forward_s": cpu_s}, 0.0
    for name, g, r in zip(("main_kf", "offset_fr_main", "main_offset", "vertex_offset"), got, ref):
        if tuple(g.shape) != tuple(r.shape) or not torch.isfinite(g).all():
            raise AssertionError(f"logits {name}: shape {tuple(g.shape)} vs {tuple(r.shape)} or non-finite")
        rel = ((g.float().cpu() - r).abs().max() / r.abs().max()).item()
        rec[f"{name}_rel_err"] = rel
        worst = max(worst, rel)
    score_err = (d_got["scores"].cpu() - d_ref["scores"]).abs().max().item()
    rec["scores_max_abs_err"] = score_err
    emit("logits", **rec)
    if worst > 1e-4 or score_err > 1e-4:
        raise AssertionError(f"GPU fp32 logits disagree with the CPU: {rec}")


def serve_phase(cfg_base, nn_model, lm, Detector) -> dict:
    cfg = cfg_base.clone()
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    det = Detector(cfg, nn_model.create_model(cfg, torch.Generator().manual_seed(0)), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    frames = [
        torch.randint(0, 256, (BATCH, H, W, 3), dtype=torch.uint8, device="cuda", generator=gen)
        for _ in range(SERVE_CALLS + 1)
    ]
    K = torch.from_numpy(np.tile(K_KITTI, (BATCH, 1, 1))).cuda()
    out = det(frames[-1], K)  # warm-up: cuDNN plans, the kernel library
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    lm.lm_solve.launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for f in frames[:SERVE_CALLS]:
        out = det(f, K)  # returns host numpy: each call ends in a sync
    end.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = lm.lm_solve.launches
    dev_ms = start.elapsed_time(end)

    shapes = {"cls": (BATCH, TOPK), "scores": (BATCH, TOPK), "valid": (BATCH, TOPK),
              "m_proj": (BATCH, TOPK, 2), "v_proj": (BATCH, TOPK, 8, 2), "bbox2d": (BATCH, TOPK, 4),
              "ry": (BATCH, TOPK), "dim": (BATCH, TOPK, 3), "loc": (BATCH, TOPK, 3),
              "cost": (BATCH, TOPK), "accepted": (BATCH, TOPK)}
    for k, shp in shapes.items():
        if out[k].shape != shp:
            raise AssertionError(f"serve: {k} has shape {out[k].shape}, expected {shp}")
        if out[k].dtype.kind == "f" and not np.isfinite(out[k]).all():
            raise AssertionError(f"serve: {k} has non-finite values")
    # the network's operations per image (all in convolutions), counted by
    # PyTorch's FlopCounterMode on meta tensors
    with FlopCounterMode(display=False) as counter, torch.inference_mode():
        nn_model.create_model(cfg).to("meta")(torch.empty(1, 3, H, W, device="meta"))
    net_flops = counter.get_total_flops()
    rec = {
        "batch": BATCH, "input": f"{W}x{H}", "dtype": "bfloat16", "calls": SERVE_CALLS,
        "images_per_s": BATCH * SERVE_CALLS / (dev_ms / 1e3),
        "ms_per_call": dev_ms / SERVE_CALLS,
        "net_gflop_per_image": net_flops / 1e9,
        "net_tflops_achieved": net_flops * BATCH * SERVE_CALLS / (dev_ms / 1e3) / 1e12,
        "net_bound_ms_per_call": net_flops * BATCH / PEAK_BF16_FLOPS * 1e3,
        "wall_images_per_s": BATCH * SERVE_CALLS / wall_s,
        "lm_launches": launches, "lm_launches_per_call": launches / SERVE_CALLS,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "valid_frac": float(out["valid"].mean()), "accepted_frac": float(out["accepted"].mean()),
    }
    emit("serve", **rec)
    if launches != 2 * SERVE_CALLS:
        raise AssertionError(f"serve: {launches} LM launches in {SERVE_CALLS} calls, expected 2 per call")
    profile_serving(det, frames[0], K)
    return rec


def profile_serving(det, frame, K) -> None:
    """torch.profiler over two detect calls: device time by kernel name and
    the device's busy share of the wall time; written to chip_smoke_out/."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            det(frame, K)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [
        {"name": e.key[:120], "device_us": e.self_device_time_total, "count": e.count}
        for e in prof.key_averages() if e.self_device_time_total > 0
    ]
    rows.sort(key=lambda r: -r["device_us"])
    # an aten:: row's device time is that of its kernels, which have rows too
    busy = sum(r["device_us"] for r in rows if not r["name"].startswith("aten::"))
    os.makedirs("chip_smoke_out", exist_ok=True)
    with open("chip_smoke_out/serve_profile.json", "w") as f:
        json.dump({"wall_us": wall_us, "device_us": busy, "kernels": rows}, f, indent=1)
    emit("profile", calls=2, wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
         idle_share=(1 - busy / wall_us) if wall_us > 0 and busy > 0 else "not measured",
         top=rows[:12])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rtm3d_tpu_torch import default_config
    from rtm3d_tpu_torch.api import Detector
    from rtm3d_tpu_torch.nn import model as nn_model
    from rtm3d_tpu_torch.ops import lm_solver as lm
    from rtm3d_tpu_torch.utils import kernel_build

    # fp32 comparisons: no TF32 in cuDNN convs or cuBLAS matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda,
         capability=list(torch.cuda.get_device_capability(0)))

    t0 = time.perf_counter()
    built = kernel_build.build()
    emit("build", seconds=time.perf_counter() - t0,
         kernels={n: {"seconds": b["seconds"],
                      "ptxas": [l.strip() for l in b["log"].splitlines() if "registers" in l or "spill" in l]}
                  for n, b in built.items()})

    cfg = default_config()
    cfg.INPUT_SIZE = (W, H)
    cfg.DETECTOR.TOPK_CANDIDATES = TOPK
    cfg.DETECTOR.SCORE_THRESH = 0.4
    cfg.DETECTOR.SOLVER_ITERS = ITERS
    prior = float(cfg.DETECTOR.DIM_PRIOR_WEIGHT)  # 20: two solves per detect
    dim_ref = np.asarray(cfg.DETECTOR.dim_ref, np.float32)
    n = BATCH * TOPK
    uv, x0, kp = synthetic_lanes(np.random.RandomState(0), n, dim_ref)
    lm_phase(lm, uv, x0, kp, n, prior)  # M = 38,400 at the prior
    # the detect path's two calls (decode/solve3d.py): 2 inits at the prior,
    # then 3 inits without it, the third being the first call's best solution
    uv2, x02, kp2 = (t[:, : 2 * n].contiguous() for t in (uv, x0, kp))
    first = lm_phase(lm, uv2, x02, kp2, n, prior)
    best = torch.from_numpy(first.pop("cost").reshape(2, n).argmin(0)).cuda()
    x_prior = first.pop("x").reshape(8, 2, n).gather(1, best[None, None].expand(8, 1, n))[:, 0]
    x03 = torch.cat([x02, x_prior], 1).contiguous()
    second = lm_phase(lm, uv, x03, kp, n, 0.0)
    logits_phase(cfg, nn_model)
    served = serve_phase(cfg, nn_model, lm, Detector)

    pair = (first, second)
    print(json.dumps({"kernels": [{
        "name": "lm_solver",
        "route": "cuda",
        "source": "rtm3d_tpu_torch/csrc/lm_solver.cu",
        "replaces": LM_REPLACES,
        "launches": served["lm_launches"],
        # per detect step: the pair of launches at M=25,600 (prior 20) and M=38,400 (prior 0)
        "max_abs_err": max(r["detection_max_abs_cost_diff_accepted"] for r in pair),
        "ms": sum(r["kernel_ms"] for r in pair),
        "plain_ms": sum(r["plain_ms"] for r in pair),
        "bound_ms": sum(r["bound_ms"] for r in pair),
        "bound_by": first["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
