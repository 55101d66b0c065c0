"""Detection cells: frames from host memory through ``Detector.__call__``,
back to back (a closed loop), the outputs checked against the reference.

The traffic file gives: ``batch``; ``frames``, ``"raw"`` (uint8 canvases of
``canvas_hw`` with the warp scalars and border colours the reader ships in
device-warp mode, resampled to the input size on the device) or
``"input"`` (uint8 frames at the input size); ``pool_batches``, distinct
batches made at set-up and cycled; ``warmup_calls``; ``car_depth_m``, the
car the vertex head draws; ``head_gain``, the gains of the heatmap and
centre-offset heads (``gen.scale_heads``); ``check_calls``, the calls the check samples
from the window; ``ref_block``, images a reference forward; and
``trace_calls``, the traced slice's length.
"""

import gc
import time

import numpy as np
import torch

from benchmark import gen, judge
from benchmark.program import Detector, port_config, port_model
from benchmark.reference import decode as ref_decode
from benchmark.reference import inputs as ref_inputs
from benchmark.reference.layers import lower_precision
from benchmark.reference.network import build_network
from benchmark.trace import Slice


class Inputs:
    """The pool of host batches, their intrinsics and warp scalars."""

    def __init__(self, conf: dict, traffic: dict, seed: int, device):
        cfg = conf["config"]
        W, H = cfg["INPUT_SIZE"]
        B, P = int(traffic["batch"]), int(traffic["pool_batches"])
        self.raw = traffic["frames"] == "raw"
        src = tuple(traffic["canvas_hw"]) if self.raw else (H, W)
        params, _ = gen.warp_params(src, (W, H), int(W))
        self.K = np.tile(camera_K(conf, traffic), (B, 1, 1))
        pix = gen.frames(seed, 2, B * P, src, device)
        self.border = pix.float().mean(dim=(1, 2)).cpu().numpy().reshape(P, B, 3) if self.raw else None
        self.images = [pix[i * B:(i + 1) * B].cpu().numpy() for i in range(P)]
        del pix
        self.warp = np.tile(np.concatenate([params, [src[1], src[0]]]).astype(np.float32), (B, 1))
        self.B = B

    def args(self, i: int):
        j = i % len(self.images)
        if self.raw:
            return self.images[j], self.K, self.warp, self.border[j]
        return self.images[j], self.K, None, None

    def __len__(self):
        return len(self.images)


def camera_K(conf: dict, traffic: dict) -> np.ndarray:
    """KITTI's intrinsics in the input frame: a ``canvas_hw`` camera frame
    resized and padded to the input size (the frames of ``"input"`` traffic
    were made so)."""
    W, H = conf["config"]["INPUT_SIZE"]
    return gen.input_K(gen.kitti_K(traffic["canvas_hw"]), gen.warp_params(tuple(traffic["canvas_hw"]), (W, H), int(W))[0])


def weights(conf: dict, traffic: dict, seed: int, device) -> dict:
    cfg = conf["config"]
    sd = gen.make_weights(conf, seed, device, cfg["TPU"]["COMPUTE_DTYPE"])
    gen.scale_heads(sd, traffic["head_gain"], cfg["TPU"]["COMPUTE_DTYPE"])
    return gen.draw_car(sd, camera_K(conf, traffic), float(traffic["car_depth_m"]), float(cfg["MODEL"]["DOWN_SAMPLE"]),
                        cfg["TPU"]["COMPUTE_DTYPE"])


def reference_logits(net, inputs: Inputs, i: int, conf: dict, block: int, device):
    """The reference network's float32 logits of pool batch ``i``."""
    cfg = conf["config"]
    W, H = cfg["INPUT_SIZE"]
    images, K, warp, border = inputs.args(i)
    x = torch.as_tensor(images, device=device)
    if warp is not None:
        x = ref_inputs.warp(x, torch.as_tensor(warp, device=device), (H, W), cfg["DATASET"]["MEAN"],
                            cfg["DATASET"]["STD"], torch.as_tensor(border, device=device))
    else:
        x = ref_inputs.normalize(x, cfg["DATASET"]["MEAN"], cfg["DATASET"]["STD"])
    outs = []
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    dtype = next(net.parameters()).dtype
    try:
        with torch.no_grad():
            for a in range(0, x.shape[0], block):
                outs.append(net(x[a:a + block].permute(0, 3, 1, 2).contiguous().to(dtype)))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    return [torch.cat(parts).float() for parts in zip(*outs)], torch.as_tensor(K, device=device)


def reference_net(conf: dict, sd: dict, device, control: bool = False, dtype=torch.float32):
    with torch.device(device):
        net = build_network(conf)
    net.load_state_dict(sd, strict=True)
    net.eval()
    return (lower_precision(net) if control else net).to(dtype)


def check(kept: list, conf: dict, traffic: dict, sd: dict, inputs: Inputs, device) -> dict:
    """Each number's worst reading over the calls kept from the window."""
    net = reference_net(conf, sd, device)
    worst = {}
    for i, out in kept:
        logits, K = reference_logits(net, inputs, i, conf, int(traffic["ref_block"]), device)
        for k, v in judge.detect_numbers(out, logits, K, conf).items():
            if isinstance(v, int):  # a count, summed over the calls
                worst[k] = worst.get(k, 0) + v
            else:
                worst[k] = max(worst.get(k, v), v)
    return worst


def control_answers(conf: dict, traffic: dict, sd: dict, inputs: Inputs, calls: int, device, side: str = "control") -> list:
    """The reference in the program's place on pool batches 0..calls-1:
    ``side`` "control", with float8 convolutions and a bfloat16 3D solve;
    "witness", the network in bfloat16 (what the served dtype alone does);
    "nonms", float32 with the decode's 3x3 suppression left out (a fault)."""
    net = reference_net(conf, sd, device, control=side == "control",
                        dtype=torch.bfloat16 if side == "witness" else torch.float32)
    heatmap = ref_decode.heatmap
    out = []
    for i in range(calls):
        logits, K = reference_logits(net, inputs, i, conf, int(traffic["ref_block"]), device)
        if side == "nonms":
            ref_decode.heatmap = lambda kf: (torch.sigmoid(kf.float()),) * 2
        try:
            det = ref_decode.detect(logits, K, conf, lm_dtype=torch.bfloat16 if side == "control" else torch.float32)
        finally:
            ref_decode.heatmap = heatmap
        out.append((i % len(inputs), {k: v.cpu().numpy() for k, v in det.items()}))
    return out


def program_answers(conf: dict, traffic: dict, sd: dict, inputs: Inputs, calls: int, device) -> list:
    """The program's answers on pool batches 0..calls-1, outside a window."""
    cfg = port_config(conf)
    detector = Detector(cfg, port_model(cfg, sd, device), device=device)
    out = [(i % len(inputs), detector(*inputs.args(i))) for i in range(calls)]
    del detector
    gc.collect()
    return out


def run(ctx) -> dict:
    conf, traffic, device, seed = ctx.conf, ctx.traffic, ctx.device, ctx.seed
    cfg = port_config(conf)
    ctx.mark("imports")
    sd = weights(conf, traffic, seed, device)
    ctx.mark("weights")
    detector = Detector(cfg, port_model(cfg, sd, device), device=device)
    ctx.mark("detector")
    inputs = Inputs(conf, traffic, seed, device)
    ctx.mark("inputs")
    call = ctx.wrap_call(detector)
    for i in range(int(traffic["warmup_calls"])):
        call(*inputs.args(i))
    ctx.sync()
    ctx.mark("warm-up")
    ctx.settle()
    rec = {"kind": "detect", "setup_s": ctx.elapsed(), "latencies_s": []}
    rng = gen.host_rng(seed, 3)
    want, kept = int(traffic["check_calls"]), []
    n_trace, tr, t_slice = int(traffic["trace_calls"]), None, None
    failed = done = 0
    ends = []  # each call's end, seconds into the window
    t0 = time.perf_counter()
    i = 0
    while True:
        if ctx.trace and tr is None and time.perf_counter() - t0 >= 0.2 * ctx.seconds:
            tr, t_slice = Slice(device).__enter__(), i
        a = time.perf_counter()
        try:
            out = call(*inputs.args(i))
        except RuntimeError:
            failed += 1
            out = None
        b = time.perf_counter()
        rec["latencies_s"].append(b - a)
        ends.append(b - t0)
        if out is not None:  # a reservoir sample of the window's answers, drawn from the seed
            done += 1
            j = len(kept) if len(kept) < want else int(rng.integers(0, done))
            if j < want:
                kept[j:j + 1] = [(i % len(inputs), out)]
        i += 1
        if tr is not None and tr.summary is None and i - t_slice == n_trace:
            tr.__exit__(None, None, None)
        if b - t0 >= ctx.seconds and (tr is None or tr.summary is not None):
            break
    rec.update(window_s=b - t0, calls=i, images=done * inputs.B, peak_allocated=torch.cuda.max_memory_allocated(device)
               if device.type == "cuda" else 0)
    if tr is not None:
        rec["trace"] = dict(tr.summary, calls=n_trace, images=n_trace * inputs.B)
    lat = sorted(rec["latencies_s"])
    rec["note"] = {f"p{q}_ms": 1e3 * lat[min(len(lat) - 1, int(q / 100 * len(lat)))] for q in (50, 90, 95, 99)}
    rec["note"]["mean_ms"] = 1e3 * sum(lat) / len(lat)
    third = ends[-1] / 3  # each third of the window alone: drift within a run against spread across runs
    parts = [[l for l, e in zip(rec["latencies_s"], ends) if k * third < e <= (k + 1) * third] for k in range(3)]
    rec["note"]["thirds_img_per_s"] = [len(q) * inputs.B / third for q in parts]
    rec["note"]["thirds_p95_ms"] = [1e3 * sorted(q)[int(0.95 * len(q))] if q else None for q in parts]
    ctx.close_window(rec)
    del detector, call
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"rec": rec, "attempted": i, "failed": failed,
            "numbers": check(kept, conf, traffic, sd, inputs, device)}
