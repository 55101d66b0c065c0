"""Training throughput: the flagship DLA-34 train step.

Port of ``tools/bench_train.py``: DLA-34 at 1280x384, MAX_OBJS 32, batch
16, fp32 by default, Adamax with the default solver, targets built on the
device (the splat kernel, one launch a step). JSON lines:

- step-only (always): ``train_step_images_per_sec_dla34_b{B}_1280x384_
  {dtype}``, the step alone re-fed one resident batch (the JAX tool's
  ``synth_batch`` frames and labels), ``--iters`` steps after one warm-up
  step, timed with CUDA events; the device's ceiling;
- ``--e2e``: ``train_e2e_images_per_sec_dla34_b{B}_{W}x{H}_{dtype}``,
  the reader, the loader (``--workers`` processes), the copy to the device,
  the device warp and the device dataset cache (``--no-device-cache`` ships
  the canvases each step instead) and the step, as an epoch runs them,
  after one warm epoch. The tree is ``--data-path`` (KITTI's layout), or
  one of 48 synthetic 372x1242 frames written to the temp directory, which
  INPUT_SIZE (1280, 1280) under IS_RECT makes 1280x384 as in the JAX
  tool; a tree of KITTI's own 375x1242 frames runs 1280x416, and the
  metric's name says the size that ran.

Each line also carries ``ms_per_step``, the TF32 flags in force, the
splat's launches a step and the peak device memory. ``--profile DIR``
writes a ``torch.profiler`` trace of the timed steps
(``utils/profiling.py::device_trace``; ``python -m
rtm3d_tpu_torch.tools.trace_times DIR`` reads it). ``--s2d-block`` is
refused: the space-to-depth stem is not ported, on purpose (ROADMAP.md).
On the CPU (``--device cpu``) the times are the host's; tests call
``run`` at a small ``hw``.

    python -m rtm3d_tpu_torch.tools.bench_train [--dtype float32|bfloat16] [--batch N] [--iters N]
        [--e2e] [--workers N] [--data-path P] [--no-device-cache] [--profile DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import tempfile

import numpy as np
import torch

from rtm3d_tpu_torch.config import default_config
from rtm3d_tpu_torch.nn.model import create_model
from rtm3d_tpu_torch.ops import splat
from rtm3d_tpu_torch.tools.bench_latency import Clock
from rtm3d_tpu_torch.train.state import TrainState
from rtm3d_tpu_torch.train.step import make_train_step, resolve_device
from rtm3d_tpu_torch.utils.profiling import device_trace

H, W, N = 384, 1280, 32


def synth_batch(rng, B: int, H: int, W: int, N: int, device) -> dict:
    """The JAX tool's ``synth_batch`` (bench_train.py:31-62), on ``device``."""
    x1 = rng.rand(B, N) * (W - 100)
    y1 = rng.rand(B, N) * (H - 60)
    labels = {
        "cls": rng.randint(0, 3, (B, N)).astype(np.int32),
        "bbox": np.stack([x1, y1, x1 + 90, y1 + 55], -1).astype(np.float32),
        "dim": (rng.rand(B, N, 3) + 0.8).astype(np.float32),
        "alpha": np.zeros((B, N), np.float32),
        "ry": rng.uniform(-3, 3, (B, N)).astype(np.float32),
        "loc": np.stack([rng.randn(B, N) * 5, rng.randn(B, N) * 0.3 + 1.2, rng.rand(B, N) * 40 + 6],
                        -1).astype(np.float32),
        "K": np.tile(np.array([721.5, 0, 609.6, 0, 721.5, 172.9, 0, 0, 1], np.float32), (B, N, 1)),
        "mask": np.ones((B, N), bool),
        "noise_mask": np.zeros((B, N), bool),
    }
    image = (rng.rand(B, H, W, 3) * 255).astype(np.uint8)
    return {"image": torch.from_numpy(image).to(device),
            "labels": {k: torch.from_numpy(v).to(device) for k, v in labels.items()}}


def _tf32() -> dict:
    return {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}


def _peak_gb(device) -> float | str:
    return torch.cuda.max_memory_allocated(device) / 1e9 if device.type == "cuda" else "not measured"


def bench_step_only(args, cfg, state, step, device, say=print) -> tuple:
    W_, H_ = cfg.INPUT_SIZE
    batch = synth_batch(np.random.RandomState(0), args.batch, H_, W_, cfg.DATASET.MAX_OBJS, device)
    state, m = step(state, batch)
    m["loss"].item()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    splat.splat_heatmap.launches = 0
    profile = device_trace(args.profile) if args.profile else contextlib.nullcontext()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    with profile, Clock(device) as clock:
        for _ in range(args.iters):
            state, m = step(state, batch)
    if args.profile:
        print(f"profile trace -> {args.profile}", file=sys.stderr)
    loss = m["loss"].item()
    out = {
        "metric": f"train_step_images_per_sec_dla34_b{args.batch}_{W_}x{H_}_{args.dtype}",
        "value": round(args.batch * args.iters / (clock.ms / 1e3), 2),
        "unit": "images/sec",
        "ms_per_step": clock.ms / args.iters,
        "wall_ms_per_step": clock.wall_ms / args.iters,
        "tf32": _tf32(),
        "remat": bool(cfg.TPU.get("REMAT", False)),
        "splat_launches_per_step": splat.splat_heatmap.launches / args.iters,
        "peak_mem_gb": _peak_gb(device),
        "loss": loss,
    }
    say(json.dumps(out))
    return state, out


def bench_e2e(args, cfg, state, device, say=print) -> tuple:
    """Reader -> loader -> device (warp, cache) -> step, as an epoch runs,
    INPUT_SIZE square at the step-only frame's longest side under IS_RECT
    (1280 at the default 384x1280)."""
    from rtm3d_tpu_torch.cli.train import build_image_cache
    from rtm3d_tpu_torch.data.kitti import create_dataset
    from rtm3d_tpu_torch.data.loader import DataLoader, prefetch_to_device
    from rtm3d_tpu_torch.data.synthetic import generate_kitti

    root = args.data_path or os.path.join(tempfile.gettempdir(), "rtm3d_torch_bench_kitti")
    if not os.path.exists(os.path.join(root, "ImageSets", "train.txt")):
        print("generating a KITTI-sized synthetic tree ...", file=sys.stderr)
        generate_kitti(root, num_train=48, num_test=0, img_hw=(372, 1242), max_objs=12)
    dcfg = cfg.clone()
    dcfg.DATASET.PATH = root
    dcfg.INPUT_SIZE = (max(cfg.INPUT_SIZE),) * 2
    dcfg.IS_RECT = True
    dcfg.TPU.DEVICE_WARP = True
    dcfg.TPU.DEVICE_DATA_CACHE = not args.no_device_cache
    dcfg.DATASET.CACHE_IMAGES = True
    ds = create_dataset(root, dcfg, is_training=True, split="train")
    dcfg.INPUT_SIZE = tuple(ds.img_size)  # the step runs the tree's rect size
    step = make_train_step(dcfg, device=device)
    image_cache = build_image_cache(ds, device)
    loader = DataLoader(ds, args.batch, shuffle=True, seed=0, num_workers=args.workers, prefetch=4)

    def run_epochs(n, start):
        nonlocal state
        steps, m = 0, None
        for ep in range(start, start + n):
            loader.set_epoch(ep)
            for b in prefetch_to_device(iter(loader), device):
                state, m = step(state, b, image_cache)
                steps += 1
        if m is None:
            raise ValueError(f"{root}: the train split holds fewer than {args.batch} frames")
        return steps, m["loss"].item()

    run_epochs(1, 0)  # warm: cuDNN plans, the loader's caches
    epochs = max(1, math.ceil(args.iters * args.batch / len(ds)))
    splat.splat_heatmap.launches = 0
    with Clock(device) as clock:
        steps, loss = run_epochs(epochs, 1)
    W_, H_ = dcfg.INPUT_SIZE
    out = {
        "metric": f"train_e2e_images_per_sec_dla34_b{args.batch}_{W_}x{H_}_{args.dtype}",
        "value": round(args.batch * steps / (clock.wall_ms / 1e3), 2),
        "unit": "images/sec",
        "ms_per_step": clock.wall_ms / steps,
        "workers": args.workers,
        "steps": steps,
        "device_cache_gb": image_cache.numel() / 1e9 if image_cache is not None else 0.0,
        "tf32": _tf32(),
        "splat_launches_per_step": splat.splat_heatmap.launches / steps,
        "loss": loss,
    }
    say(json.dumps(out))
    return state, out


def parse_args(argv=None):
    ap = argparse.ArgumentParser("bench_train")
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--e2e", action="store_true", help="also run the loader->device epoch bench")
    ap.add_argument("--workers", type=int, default=0)
    ap.add_argument("--data-path", default="")
    ap.add_argument("--no-device-cache", action="store_true", help="ship the canvases each step in the e2e bench")
    ap.add_argument("--profile", default="", help="write a torch.profiler trace of the timed steps to this dir")
    ap.add_argument("--s2d-block", type=int, default=0, help="refused: the space-to-depth stem is not ported")
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None, say=print) -> dict:
    return run(parse_args(argv), say=say)


def run(args, hw=(H, W), say=print) -> dict:
    """The benches ``args`` (``parse_args``) ask for, the step-only one at
    ``hw``."""
    if args.s2d_block:
        raise SystemExit("--s2d-block: the space-to-depth stem is not ported, on purpose (an exact "
                         "reparameterisation of the plain stem for the TPU; ROADMAP.md)")
    device = resolve_device(None if args.device == "cuda" else args.device)
    h, w = hw
    cfg = default_config()
    cfg.MODEL.BACKBONE = "DLA-34"
    cfg.INPUT_SIZE = (w, h)
    cfg.DATASET.MAX_OBJS = N
    cfg.TPU.COMPUTE_DTYPE = args.dtype
    state = TrainState.create(create_model(cfg, torch.Generator().manual_seed(0)), cfg, device=device)
    state, step_only = bench_step_only(args, cfg, state, make_train_step(cfg, device=device), device, say)
    out = {"step_only": step_only}
    if args.e2e:
        out["e2e"] = bench_e2e(args, cfg, state, device, say)[1]
    return out


if __name__ == "__main__":
    main()
