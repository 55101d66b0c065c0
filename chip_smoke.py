#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (rtm3d_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py    # from the repository root
    python3 chip_smoke.py --kernel-ab DIR [--check-only] [--out FILE]

With no arguments it drives the port's main paths and checks them, in
phases of one JSON line each; any failure exits non-zero:
  device   the card (nvidia-smi name and power limit), torch and CUDA versions;
  build    compiles rtm3d_tpu_torch/csrc/*.cu (nvcc, one process per source)
           and fails if ptxas reports a spill store or load in any kernel;
  lm_*     the LM kernel against its plain PyTorch version on the card at
           the detect path's lane counts (M = 25,600 and 38,400 for batch
           128 x top-K 100, the second call's third init being the first
           call's solution), accept-mask agreement >= 99.9% and, where both
           accept, cost within 1e-3 on >= 99.9% (per lane at the prior, per
           detection without it), CUDA-event times and the fp32 bound, the
           launch geometry (threads per detection, block size, blocks);
  logits   full-width DLA-34 1280x384 fp32 forward, port on the GPU against
           the port on the CPU (TF32 off), max |d| <= 1e-4 of max |logit|;
  serve    DLA-34 1280x384 batch 128 bf16 detect through Detector, distinct
           uint8 frames per call, a KITTI K: exactly 2 LM launches per call,
           finite outputs of the right shapes, images/s from CUDA events;
  profile  torch.profiler over two serving calls: device time by kernel,
           idle share; the full table goes to chip_smoke_out/serve_profile.json;
  splat    the heatmap splat kernel against its plain PyTorch version at the
           training path's shape (B 32, N 64, C 3, 96x320, the inputs
           build_targets makes from the train batch) and on an edge batch
           (centers off the map, R = 0, an all-masked image, noise slots, two
           classes on one center): max |d| <= 1e-6 and the same pixels equal
           to 1.0; CUDA-event times, bytes, operations and the bound, the
           mean live slots per tile;
  train_fp32  DLA-34 384x128 batch 2 fp32 (TF32 off), one make_train_step on
           the GPU against the same step on the CPU, same seed-0 weights and
           batch: loss and aux within 1e-4 relative, gradients within
           this network's float32 noise floor (whole gradient <= 5e-2 and
           each tensor <= 1e-1 relative in L2; on the CPU float32 against
           float64 differs by 0.95% and at most 1.3%, GPU against CPU by
           2.1% and 3.2% on the H100);
  train    configs/rtm3d_dla34_kitti_tpu.yaml's model and solver at full
           width, DLA-34 1280x384 batch 32 bf16 autocast, EMA, MAX_OBJS 64,
           synthetic uint8 frames and label blocks (a quarter of the slots
           masked, a tenth noise): 3 warm-up steps, 10 timed steps on
           distinct batches, 2 eval-loss steps; finite loss and aux, one
           splat launch per step; then 20 steps on one batch with
           WARMUP_ITERS 0, whose loss must fall; images/s, ms per step and
           peak memory;
  train_profile  torch.profiler over two train steps, the table to
           chip_smoke_out/train_profile.json.
Then the seconds of each phase, the kernels line, the nvidia-smi line and,
last, {"ok": true, ...}. Needs one CUDA device; without one it exits
non-zero and prints no result.

With --kernel-ab it compares the CUDA kernels of another version of the
port with this one's instead, on the same card: DIR holds that version's
``rtm3d_tpu_torch`` package (from PR 2 on; for example ``git archive <rev>
rtm3d_tpu_torch | tar -x -C DIR``). Each version runs in a process of its
own that imports its package and goes through its public wrappers
(``lm_solve``, ``splat_heatmap``), in turns old, new, new, old: ptxas's
registers and spills, agreement with the plain versions as above, the LM
at M = 25,600 (prior 20) and 38,400 (prior 0) with CUDA events, the splat
at B 32, N 64, C 3, 96x320 with torch.profiler device time (and, to show
where its time goes, with every slot masked out, beside a PyTorch fill of
the same output). Then the SASS of each LM kernel's iteration loop by
opcode (cuobjdump, where the toolkit has it). --check-only runs each
version once, untimed. A line per record; all of them go to FILE
(chip_smoke_out/kernel_ab.json).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from rtm3d_tpu_torch.utils.measure import (
    BATCH, FRAME_H, FRAME_W, ITERS, K_KITTI, PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_FP32_FLOPS, TOPK,
    TRAIN_BATCH, TRAIN_OBJS, cuda_time_ms, kernel_device_ms, lm_agreement, nvidia_smi,
    splat_edge_inputs, synthetic_labels, synthetic_lanes,
)

H, W = FRAME_H, FRAME_W
SERVE_CALLS = 6
LM_REPLACES = "rtm3d_tpu/ops/lm_solver.py:35"
SPLAT_REPLACES = "rtm3d_tpu/ops/splat.py:26"
TRAIN_WARMUP, TRAIN_TIMED, LOSS_FALL_STEPS = 3, 10, 20
AB_LM_REPS, AB_SPLAT_REPS = 20, 100


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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

    lane = lm_agreement(ck, cr)
    # what the detect path gates on: per detection, the least cost over its inits
    det = lm_agreement(ck.reshape(-1, n_det).min(0), cr.reshape(-1, n_det).min(0))
    kernel_ms = cuda_time_ms(lambda: lm.lm_solve(uv, x0, kp, iters=ITERS, prior_weight=prior_weight), 20, 2)
    plain_ms = cuda_time_ms(lambda: lm.lm_solve_reference(uv, x0, kp, iters=ITERS, prior_weight=prior_weight), 3)
    flops, nbytes = lm.lm_flops(m, ITERS, prior_weight), lm.lm_bytes(m)
    bound_ms = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    blocks, threads = lm.lm_launch_geometry(m, torch.cuda.get_device_properties(0).multi_processor_count)
    rec = {
        "M": m, "detections": n_det, "prior_weight": prior_weight,
        "lanes_per_detection": 1,  # the kernel's design: one thread per detection
        "block_threads": threads, "blocks": blocks,
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


def serve_phase(cfg_base, nn_model, lm, splat, Detector) -> dict:
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

    lm.lm_solve.launches = splat.splat_heatmap.launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for f in frames[:SERVE_CALLS]:
        out = det(f, K)  # returns host numpy: each call ends in a sync
    end.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, splat_launches = lm.lm_solve.launches, splat.splat_heatmap.launches
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
    if launches != 2 * SERVE_CALLS or splat_launches != 0:
        raise AssertionError(f"serve: {launches} LM launches in {SERVE_CALLS} calls, expected 2 per call "
                             f"(and {splat_launches} splat launches, expected none)")
    profile_calls("profile", lambda: det(frames[0], K), 2, "chip_smoke_out/serve_profile.json")
    return rec


def profile_calls(phase: str, call, calls: int, path: str) -> dict:
    """torch.profiler over ``calls`` runs of ``call()``: device time by kernel
    name and the device's busy share of the wall time; the table goes to
    ``path``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
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
    with open(path, "w") as f:
        json.dump({"wall_us": wall_us, "device_us": busy, "kernels": rows}, f, indent=1)
    rec = {"calls": calls, "wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
           "idle_share": (1 - busy / wall_us) if wall_us > 0 and busy > 0 else "not measured",
           "top": [r for r in rows if not r["name"].startswith("aten::")][:15]}
    emit(phase, **rec)
    return rec


def splat_phase(splat, inputs, feat_hw, num_classes: int, name: str) -> dict:
    """Kernel against plain version on the same inputs: max |d| <= 1e-6 and
    the same set of pixels equal to 1.0 (what the focal loss counts)."""
    got = splat.splat_heatmap(*inputs, feat_hw, num_classes)
    torch.cuda.synchronize()
    ref = splat.splat_heatmap_reference(*inputs, feat_hw, num_classes)
    err = (got - ref).abs().max().item()
    ones_equal = bool(torch.equal(got == 1.0, ref == 1.0))
    # back to back from Python the wrapper's host work outruns the kernel, so
    # the per-call event time is host-bound; the kernel's own device time
    # comes from the profiler
    call_ms = cuda_time_ms(lambda: splat.splat_heatmap(*inputs, feat_hw, num_classes), 50, 3)
    kernel_ms = kernel_device_ms(lambda: splat.splat_heatmap(*inputs, feat_hw, num_classes), 20, "splat_kernel")
    plain_ms = cuda_time_ms(lambda: splat.splat_heatmap_reference(*inputs, feat_hw, num_classes), 5, 1)
    B, N = inputs[1].shape
    nbytes = splat.splat_bytes(B, N, feat_hw, num_classes)
    flops = splat.splat_flops(inputs[0], inputs[3], inputs[4], feat_hw)
    bound_ms = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    tile = splat.splat_tile_shape()
    live = splat.splat_live_slots(inputs[0], inputs[3], inputs[4], feat_hw, tile).float()
    rec = {
        "shape": [B, N, num_classes, *feat_hw], "max_abs_err": err, "ones_equal": ones_equal,
        "tile": list(tile), "tiles": live.numel(), "mean_live_slots_per_tile": live.mean().item(),
        "ones": int((ref == 1.0).sum().item()), "nonzero_frac": float((ref > 0).float().mean().item()),
        "kernel_ms": kernel_ms, "kernel_us": kernel_ms * 1e3, "call_ms": call_ms, "plain_ms": plain_ms,
        "bytes": nbytes, "flops": flops, "bound_ms": bound_ms,
        "bound_by": "operations" if flops / PEAK_FP32_FLOPS > nbytes / PEAK_BYTES else "bytes",
    }
    emit(f"splat_{name}", **rec)
    if not torch.isfinite(got).all() or err > 1e-6 or not ones_equal:
        raise AssertionError(f"splat kernel disagrees with its plain version: {rec}")
    return rec


def train_fp32_phase(cfg_base, nn_model, step_mod, state_mod) -> None:
    """One train step of DLA-34 at 384x128 batch 2 in fp32 on the GPU against
    the same step on the CPU. The float32 gradient of this network at random
    init is noisy: on the CPU, float32 against float64 differs by 0.95% of
    the whole gradient (L2) and by up to 1.3% in one tensor; GPU against CPU
    by 2.1% and 3.2% on an H100. So the gradients are held at 5e-2
    and 1e-1 in L2 (a wrong backward is off by O(1)); loss and aux at 1e-4
    relative."""
    cfg = cfg_base.clone()
    cfg.INPUT_SIZE = (384, 128)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    model = nn_model.create_model(cfg, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(3)
    batch = {"image": torch.from_numpy((rng.rand(2, 128, 384, 3) * 255).astype(np.uint8)),
             "labels": synthetic_labels(rng, 2, TRAIN_OBJS, scale=0.3)}
    out = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        state = state_mod.TrainState.create(model, cfg, device=dev)
        state, m = step_mod.make_train_step(cfg, device=dev)(state, batch)
        grads = {k: p.grad.detach().double().cpu() for k, p in state.model.named_parameters()}
        out[dev] = (m["loss"].item(), m["loss_items"].double().cpu(), grads, time.perf_counter() - t0)
    (lg, ag, gg, tg), (lc, ac, gc, tc) = out["cuda"], out["cpu"]
    loss_rel = abs(lg - lc) / abs(lc)
    aux_rel = ((ag - ac).abs() / ac.abs().clamp(min=1e-12)).max().item()
    per = {k: ((gg[k] - gc[k]).norm() / gc[k].norm()).item() for k in gc if gc[k].norm() > 0}
    flat_g, flat_c = torch.cat([g.flatten() for g in gg.values()]), torch.cat([g.flatten() for g in gc.values()])
    total = ((flat_g - flat_c).norm() / flat_c.norm()).item()
    worst = max(per, key=per.get)
    max_rel = {k: ((gg[k] - gc[k]).abs().max() / gc[k].abs().max()).item() for k in per}
    rec = {"input": "384x128", "batch": 2, "loss_gpu": lg, "loss_cpu": lc, "loss_rel": loss_rel,
           "aux_max_rel": aux_rel, "grad_l2_rel_total": total, "grad_l2_rel_worst": per[worst],
           "grad_l2_rel_worst_tensor": worst, "grad_l2_rel_median": float(np.median(list(per.values()))),
           "grad_max_over_tensor_max_worst": max(max_rel.values()),
           "grad_max_over_tensor_max_median": float(np.median(list(max_rel.values()))),
           "gpu_step_s": tg, "cpu_step_s": tc}
    emit("train_fp32", **rec)
    if not np.isfinite(lg) or loss_rel > 1e-4 or aux_rel > 1e-4 or per[worst] > 1e-1 or total > 5e-2:
        raise AssertionError(f"train step on the GPU disagrees with the CPU: {rec}")


def train_phase(nn_model, step_mod, state_mod, load_config, lm, splat) -> dict:
    """configs/rtm3d_dla34_kitti_tpu.yaml at full width on distinct synthetic
    batches, then the loss-falls check on one repeated batch."""
    cfg = load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "configs", "rtm3d_dla34_kitti_tpu.yaml"))
    cfg.INPUT_SIZE = (W, H)  # the rect shape of (1280, 1280) IS_RECT on KITTI frames
    cfg.BATCH_SIZE, cfg.DATASET.MAX_OBJS = TRAIN_BATCH, TRAIN_OBJS  # the file's 32 and the default 64
    gen = torch.Generator(device="cuda").manual_seed(4)
    rng = np.random.RandomState(4)
    batches = [
        {"image": torch.randint(0, 256, (TRAIN_BATCH, H, W, 3), dtype=torch.uint8, device="cuda", generator=gen),
         "labels": {k: v.cuda() for k, v in synthetic_labels(rng, TRAIN_BATCH, TRAIN_OBJS).items()}}
        for _ in range(TRAIN_WARMUP + TRAIN_TIMED)
    ]
    model = nn_model.create_model(cfg, torch.Generator().manual_seed(0))
    state = state_mod.TrainState.create(model, cfg, device="cuda")
    step = step_mod.make_train_step(cfg, device="cuda")
    eval_step = step_mod.make_eval_loss_step(cfg, device="cuda")
    for b in batches[:TRAIN_WARMUP]:
        state, _ = step(state, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    lm.lm_solve.launches = splat.splat_heatmap.launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    metrics = []
    t0 = time.perf_counter()
    start.record()
    for b in batches[TRAIN_WARMUP:]:
        state, m = step(state, b)
        metrics.append(m)
    end.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    train_launches, train_lm = splat.splat_heatmap.launches, lm.lm_solve.launches
    dev_ms = start.elapsed_time(end)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    splat.splat_heatmap.launches = 0
    evals = [eval_step(state, b) for b in batches[:2]]
    torch.cuda.synchronize()
    eval_launches = splat.splat_heatmap.launches

    losses = torch.stack([m["loss"] for m in metrics]).cpu()
    aux = torch.stack([m["loss_items"] for m in metrics] + [e["loss_items"] for e in evals]).cpu()
    rec = {
        "batch": TRAIN_BATCH, "input": f"{W}x{H}", "dtype": "bfloat16 autocast", "ema": True,
        "max_objs": TRAIN_OBJS, "timed_steps": TRAIN_TIMED,
        "images_per_s": TRAIN_BATCH * TRAIN_TIMED / (dev_ms / 1e3), "ms_per_step": dev_ms / TRAIN_TIMED,
        "wall_images_per_s": TRAIN_BATCH * TRAIN_TIMED / wall_s, "peak_mem_gb": peak_gb,
        "splat_launches": train_launches, "lm_launches": train_lm, "eval_splat_launches": eval_launches,
        "loss_first": losses[0].item(), "loss_last": losses[-1].item(),
        "eval_loss": [e["loss"].item() for e in evals],
        "num_targets": int(metrics[0]["num_targets"].item()),
    }
    del state, metrics, evals
    torch.cuda.empty_cache()

    # the loss falls on one repeated batch
    fall_cfg = cfg.clone()
    fall_cfg.SOLVER.WARMUP_ITERS = 0
    state = state_mod.TrainState.create(model, fall_cfg, device="cuda")
    step = step_mod.make_train_step(fall_cfg, device="cuda")
    fall = []
    for _ in range(LOSS_FALL_STEPS):
        state, m = step(state, batches[0])
        fall.append(m["loss"])
    fall = torch.stack(fall).cpu()
    rec["repeated_batch_loss"] = [round(v, 4) for v in fall.tolist()]
    emit("train", **rec)
    if not (torch.isfinite(losses).all() and torch.isfinite(aux).all() and torch.isfinite(fall).all()):
        raise AssertionError(f"train: non-finite loss or aux {rec}")
    if train_launches != TRAIN_TIMED or eval_launches != 2 or train_lm != 0:
        raise AssertionError(f"train: expected one splat launch per step, got {rec}")
    if not fall[-1] < fall[0]:
        raise AssertionError(f"train: the loss did not fall over {LOSS_FALL_STEPS} steps on one batch: {rec}")
    profile_calls("train_profile", lambda: step(state, batches[1]), 2, "chip_smoke_out/train_profile.json")
    return rec


def ptxas_lines(log: str) -> list:
    """ptxas's resource lines (registers, spills) from an nvcc -Xptxas -v log."""
    return [l.strip() for l in log.splitlines() if "registers" in l or "spill" in l]


def ab_worker(root: str, timed: bool) -> None:
    """One turn of --kernel-ab: the kernels of the ``rtm3d_tpu_torch`` package
    under ``root``, built, checked against their plain versions at the main
    paths' shapes and, if ``timed``, timed; one JSON line."""
    # this script's own package came in with the shared helpers; the turn
    # imports the version under test in its place
    for name in [k for k in sys.modules if k.split(".")[0] == "rtm3d_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, os.path.abspath(root))
    from rtm3d_tpu_torch import default_config
    from rtm3d_tpu_torch.data.targets import heatmap_inputs
    from rtm3d_tpu_torch.ops import lm_solver as lm
    from rtm3d_tpu_torch.ops import splat
    from rtm3d_tpu_torch.utils import kernel_build

    built = kernel_build.build()
    rec = {"package": os.path.dirname(os.path.dirname(lm.__file__)),
           "ptxas": {n: ptxas_lines(b["log"]) for n, b in built.items()},
           "libraries": {n: str(b["path"]) for n, b in built.items()}, "lm": []}
    cfg = default_config()
    n = BATCH * TOPK
    uv, x0, kp = synthetic_lanes(np.random.RandomState(0), n, np.asarray(cfg.DETECTOR.dim_ref, np.float32))
    cases = [tuple(t[:, : 2 * n].contiguous() for t in (uv, x0, kp)) + (float(cfg.DETECTOR.DIM_PRIOR_WEIGHT),),
             (uv, x0, kp, 0.0)]
    for u, x, k, pw in cases:
        call = lambda: lm.lm_solve(u, x, k, iters=ITERS, prior_weight=pw)
        ck = call()[1][0].cpu().numpy()
        cr = lm.lm_solve_reference(u, x, k, iters=ITERS, prior_weight=pw)[1][0].cpu().numpy()
        # held as lm_phase holds them: per lane at the prior, per detection without
        held = lm_agreement(ck, cr) if pw > 0 else lm_agreement(ck.reshape(-1, n).min(0), cr.reshape(-1, n).min(0))
        entry = {"M": u.shape[1], "prior_weight": pw, "finite": bool(np.isfinite(ck).all()),
                 "accept_agreement": held[0], "cost_within_1e-3": held[1]}
        if timed:
            entry["ms"] = cuda_time_ms(call, AB_LM_REPS, 2)
        rec["lm"].append(entry)
    feat_hw = (H // 4, W // 4)
    labels = {k: v.cuda() for k, v in synthetic_labels(np.random.RandomState(5), TRAIN_BATCH, TRAIN_OBJS).items()}
    inputs = heatmap_inputs(labels)
    for name, batch in (("train_shape", inputs), ("edge", splat_edge_inputs(4, TRAIN_OBJS, feat_hw))):
        got = splat.splat_heatmap(*batch, feat_hw, 3)
        ref = splat.splat_heatmap_reference(*batch, feat_hw, 3)
        rec[f"splat_{name}"] = {"max_abs_err": (got - ref).abs().max().item(),
                                "ones_equal": bool(torch.equal(got == 1.0, ref == 1.0))}
    if timed:
        masked_out = list(inputs)
        masked_out[4] = torch.zeros_like(inputs[4])
        out = torch.empty((TRAIN_BATCH, 3, *feat_hw), device="cuda")
        rec["splat_ms"] = kernel_device_ms(lambda: splat.splat_heatmap(*inputs, feat_hw, 3), AB_SPLAT_REPS,
                                           "splat_kernel")
        rec["splat_no_live_slot_ms"] = kernel_device_ms(lambda: splat.splat_heatmap(*masked_out, feat_hw, 3),
                                                        AB_SPLAT_REPS, "splat_kernel")
        rec["fill_ms"] = kernel_device_ms(lambda: out.fill_(0.5), AB_SPLAT_REPS, "elementwise")
    print(json.dumps(rec), flush=True)


def sass_loop_counts(lib: str, kernel: str) -> dict:
    """Per function whose name holds ``kernel``: its SASS instruction count
    and, over the span of its widest backward branch (the iteration loop),
    the count by opcode."""
    tool = shutil.which("cuobjdump") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.isfile(tool):
        return {"cuobjdump": "not found"}
    text = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*)", line)
        if name and m:
            funcs[name].append((int(m.group(1), 16), m.group(2), m.group(3)))
    out = {}
    for fn, ins in funcs.items():
        if kernel not in fn:
            continue
        loops = []
        for addr, op, rest in ins:
            t = re.search(r"0x([0-9a-f]+)", rest)
            if op.startswith("BRA") and t and int(t.group(1), 16) < addr:
                loops.append((int(t.group(1), 16), addr))
        rec = {"instructions": len(ins)}
        if loops:
            lo, hi = max(loops, key=lambda span: span[1] - span[0])
            by_op = {}
            for addr, op, _ in ins:
                if lo <= addr <= hi:
                    by_op[op.split(".")[0]] = by_op.get(op.split(".")[0], 0) + 1
            rec["loop_instructions"] = sum(by_op.values())
            rec["loop_by_opcode"] = dict(sorted(by_op.items(), key=lambda kv: -kv[1]))
        out[fn] = rec
    return out


def kernel_ab(old_root: str, check_only: bool, out_path: str) -> int:
    """--kernel-ab: the package under ``old_root`` against this one, each
    turn in a process of its own; fails if either version fails a gate."""
    from rtm3d_tpu_torch.ops import lm_solver as lm
    from rtm3d_tpu_torch.ops import splat

    roots = {"old": old_root, "new": os.path.dirname(os.path.abspath(__file__))}
    records, runs = [], {"old": [], "new": []}

    def record(kind, **fields):
        records.append({"record": kind, **fields})
        print(json.dumps(records[-1]), flush=True)

    smi = nvidia_smi()
    record("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    for tag in ("old", "new") if check_only else ("old", "new", "new", "old"):
        cmd = [sys.executable, os.path.abspath(__file__), "--ab-worker", roots[tag]] + ([] if check_only else ["--timed"])
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            raise RuntimeError(f"kernel-ab: the {tag} turn exited {proc.returncode}")
        runs[tag].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        record("turn", version=tag, **runs[tag][-1])
    failed = []
    for tag, turns in runs.items():
        first = turns[0]
        record("sass", version=tag, lm_solver=sass_loop_counts(first["libraries"]["lm_solver"], "lm_kernel"))
        for t in turns:
            for e in t["lm"]:
                if not e["finite"] or e["accept_agreement"] < 0.999 or e["cost_within_1e-3"] < 0.999:
                    failed.append((tag, e))
            for name in ("splat_train_shape", "splat_edge"):
                if t[name]["max_abs_err"] > 1e-6 or not t[name]["ones_equal"]:
                    failed.append((tag, name, t[name]))
        if check_only:
            continue
        lm_ms = [float(np.mean([t["lm"][i]["ms"] for t in turns])) for i in range(2)]
        lm_bound = [lm.lm_flops(e["M"], ITERS, e["prior_weight"]) / PEAK_FP32_FLOPS * 1e3 for e in first["lm"]]
        splat_bound = splat.splat_bytes(TRAIN_BATCH, TRAIN_OBJS, (H // 4, W // 4), 3) / PEAK_BYTES * 1e3
        mean = lambda key: float(np.mean([t[key] for t in turns]))
        record("times", version=tag, nvidia_smi=smi,
               lm_ms={e["M"]: ms for e, ms in zip(first["lm"], lm_ms)}, lm_pair_ms=sum(lm_ms),
               lm_pair_bound_ms=sum(lm_bound), lm_pair_over_bound=sum(lm_ms) / sum(lm_bound),
               lm_runs_ms=[[e["ms"] for e in t["lm"]] for t in turns],
               splat_ms=mean("splat_ms"), splat_runs_ms=[t["splat_ms"] for t in turns],
               splat_bound_ms=splat_bound, splat_over_bound=mean("splat_ms") / splat_bound,
               splat_no_live_slot_ms=mean("splat_no_live_slot_ms"), fill_ms=mean("fill_ms"))
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(records, f, indent=1)
    print(smi, flush=True)
    if failed:
        print(f"kernel-ab: a version fails its gates: {failed}", file=sys.stderr)
        return 1
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description="Drive the port on one GPU and check it.")
    ap.add_argument("--kernel-ab", metavar="DIR", help="compare the kernels of the package under DIR with these")
    ap.add_argument("--check-only", action="store_true", help="with --kernel-ab: each version once, untimed")
    ap.add_argument("--out", default="chip_smoke_out/kernel_ab.json", help="with --kernel-ab: the records")
    ap.add_argument("--ab-worker", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--timed", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    if args.ab_worker:
        ab_worker(args.ab_worker, args.timed)
        return 0
    if args.kernel_ab:
        return kernel_ab(args.kernel_ab, args.check_only, args.out)
    from rtm3d_tpu_torch import default_config, load_config
    from rtm3d_tpu_torch.api import Detector
    from rtm3d_tpu_torch.data.targets import heatmap_inputs
    from rtm3d_tpu_torch.nn import model as nn_model
    from rtm3d_tpu_torch.ops import lm_solver as lm
    from rtm3d_tpu_torch.ops import splat
    from rtm3d_tpu_torch.train import state as state_mod
    from rtm3d_tpu_torch.train import step as step_mod
    from rtm3d_tpu_torch.utils import kernel_build

    # fp32 comparisons: no TF32 in cuDNN convs or cuBLAS matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    seconds = {}
    t_phase = time.perf_counter()

    def phase_done(name):
        nonlocal t_phase
        now = time.perf_counter()
        seconds[name] = round(now - t_phase, 2)
        t_phase = now

    smi = nvidia_smi()
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda,
         capability=list(torch.cuda.get_device_capability(0)))

    built = kernel_build.build()  # one nvcc per source, all at once
    ptxas = {n: ptxas_lines(b["log"]) for n, b in built.items()}
    spills = {n: [l for l in lines if re.search(r"[1-9]\d* bytes spill (stores|loads)", l)]
              for n, lines in ptxas.items()}
    emit("build", seconds=time.perf_counter() - t_phase,
         kernels={n: {"seconds": b["seconds"], "ptxas": ptxas[n]} for n, b in built.items()})
    if not all(any("registers" in l for l in lines) for lines in ptxas.values()):
        raise AssertionError(f"build: a kernel's ptxas report is missing: {ptxas}")
    if any(spills.values()):
        raise AssertionError(f"build: ptxas reports spills: {spills}")
    phase_done("build")

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
    phase_done("lm")
    logits_phase(cfg, nn_model)
    phase_done("logits")
    served = serve_phase(cfg, nn_model, lm, splat, Detector)
    phase_done("serve_and_profile")

    # the splat at the training path's shape: the inputs build_targets makes
    # from a train batch's label block
    feat_hw = (H // 4, W // 4)
    labels = {k: v.cuda() for k, v in synthetic_labels(np.random.RandomState(5), TRAIN_BATCH, TRAIN_OBJS).items()}
    splat_main = splat_phase(splat, heatmap_inputs(labels), feat_hw, 3, "train_shape")
    splat_edge = splat_phase(splat, splat_edge_inputs(4, TRAIN_OBJS, feat_hw), feat_hw, 3, "edge")
    phase_done("splat")
    train_fp32_phase(cfg, nn_model, step_mod, state_mod)
    phase_done("train_fp32")
    trained = train_phase(nn_model, step_mod, state_mod, load_config, lm, splat)
    phase_done("train_and_profile")
    emit("seconds", **seconds, total=round(sum(seconds.values()), 2))

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
    }, {
        "name": "splat",
        "route": "cuda",
        "source": "rtm3d_tpu_torch/csrc/splat.cu",
        "replaces": SPLAT_REPLACES,
        # one launch per train step: the timed steps of the train phase
        "launches": trained["splat_launches"],
        "max_abs_err": max(splat_main["max_abs_err"], splat_edge["max_abs_err"]),
        "ms": splat_main["kernel_ms"],
        "plain_ms": splat_main["plain_ms"],
        "bound_ms": splat_main["bound_ms"],
        "bound_by": splat_main["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
