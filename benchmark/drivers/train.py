"""Training cells: one train state stepped back to back over a device
dataset cache, checked against the reference twice: its first three steps
from the seed, and, once the window has closed, three more steps driven
through the same call from the state the window left, which the reference
takes up (the program's own parameters, Adamax moments and EMA).

The traffic file gives: ``batch``; ``canvas_hw`` and ``dataset_frames``,
the raw uint8 canvases made into the device cache at set-up (KITTI's train
split: 3,712 frames of 375x1242); ``objects_per_frame``, the Poisson mean
of the labelled objects; ``check_steps``, the steps set-up drives and the
reference follows, and as many after the window; ``trace_calls``, the traced slice's length.

Each step ships what the loader ships in device-cache mode: ``image_idx``,
``warp`` (sx, sy, tx, ty, w0, h0, with the reader's scale and mirror
draws), ``photo`` (alpha, beta, std and the seed column), ``border`` (each
frame's mean colour) and the label block padded to MAX_OBJS. The batches
are a seeded permutation of the dataset, so the rows of every step differ.
"""

import gc
import math
import time

import numpy as np
import torch

from benchmark import gen, judge
from benchmark.program import TrainState, make_train_step, port_config, port_model
from benchmark.reference import train as ref_train
from benchmark.reference.layers import lower_precision
from benchmark.reference.network import build_network
from benchmark.trace import Slice


def dataset(conf: dict, traffic: dict, seed: int, device):
    """(device cache (N, H0, W0, 3) uint8, host batches)."""
    cfg = conf["config"]
    W, H = cfg["INPUT_SIZE"]
    B, N = int(traffic["batch"]), int(traffic["dataset_frames"])
    h0, w0 = traffic["canvas_hw"]
    cache = gen.frames(seed, 4, N, (h0, w0), device)
    border = torch.cat([cache[a:a + 256].float().mean(dim=(1, 2)) for a in range(0, N, 256)]).cpu().numpy()
    rng = gen.host_rng(seed, 5)
    order = rng.permutation(N)
    batches = []
    for s in range(N // B):
        idx = order[s * B:(s + 1) * B]
        warp, photo, Ks = [], [], []
        for _ in idx:  # the reader's draws (data/kitti.py), in its order
            alpha = 1.0 + rng.uniform(-0.2, 0.2) if rng.random() < 0.5 else 1.0
            beta = rng.uniform(-0.2, 0.2) if alpha != 1.0 else 0.0
            std = rng.uniform(10.0, 50.0) ** 0.5 if rng.random() < 0.5 else 0.0
            photo.append([alpha, beta, std, rng.integers(0, 2 ** 31 - 1)])
            scale = rng.uniform(1.0, 1.2) if rng.random() < 0.5 else 1.0
            params, _ = gen.warp_params((h0, w0), (W, H), int(W), scale, bool(rng.random() < 0.5))
            warp.append(np.concatenate([params, [w0, h0]]))
            Ks.append(gen.input_K(gen.kitti_K((h0, w0)), params))
        labels = gen.labels(rng, B, int(cfg["DATASET"]["MAX_OBJS"]), float(traffic["objects_per_frame"]),
                            np.stack(Ks), (W, H), cfg["DETECTOR"]["dim_ref"])
        batches.append({"image_idx": idx.astype(np.int32), "warp": np.asarray(warp, np.float32),
                        "photo": np.asarray(photo, np.float32), "border": border[idx].astype(np.float32),
                        "labels": labels})
    return cache, batches


def program_readings(state, step, batches, cache, n: int) -> tuple:
    """Drive ``state`` through its first ``n`` steps: the losses, the first
    update's gradient from the Adamax state, the leaves after ``n``."""
    names = {p: k for k, p in state.model.named_parameters()}
    beta1 = state.optimizer.param_groups[0]["betas"][0]
    out = {"loss": []}
    for t in range(n):
        state, m = step(state, batches[t], cache)
        out["loss"].append(float(m["loss"]))
        if t == 0:
            out["grad"] = {names[p]: s["exp_avg"] / (1 - beta1) for p, s in state.optimizer.state.items()}
            out["grad"] = {k: v.detach().clone() for k, v in out["grad"].items()}
    out["params"] = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    out["ema"] = {k: v.clone() for k, v in state.ema.items()} if state.ema is not None else None
    return state, out


def snapshot(state) -> dict:
    """The program's state as the reference takes it to go on from: the
    updates so far, the float32 leaves, Adamax's two moments, the EMA."""
    names = {p: k for k, p in state.model.named_parameters()}
    opt = state.optimizer.state
    return {"t": int(state.updates), "params": {k: p.detach().clone() for k, p in state.model.named_parameters()},
            "m": {names[p]: opt[p]["exp_avg"].clone() for p in names},
            "u": {names[p]: opt[p]["exp_inf"].clone() for p in names},
            "ema": {k: v.clone() for k, v in state.ema.items()} if state.ema is not None else None}


def late_readings(state, step, batches, cache, n: int) -> tuple:
    """Drive ``state`` ``n`` steps on ``batches`` from where it stands (after
    the window): (its snapshot before them, the losses, the leaves and the
    EMA after them)."""
    start = snapshot(state)
    out = {"loss": []}
    for b in batches[:n]:
        state, m = step(state, b, cache)
        out["loss"].append(float(m["loss"]))
    out["params"] = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    out["ema"] = {k: v.clone() for k, v in state.ema.items()} if state.ema is not None else None
    return state, start, out


def reference_readings(conf: dict, sd: dict, batches, cache, device, control: bool = False, autocast=None,
                       start=None) -> dict:
    with torch.device(device):
        net = build_network(conf)
    net.load_state_dict(sd, strict=True)
    net.train()
    if control:
        lower_precision(net)
    return ref_train.steps(net, batches, cache, conf, autocast, start)


def window_batches(batches: list, first: int, n: int) -> list:
    return [batches[(first + j) % len(batches)] for j in range(n)]


def run(ctx) -> dict:
    conf, traffic, device, seed = ctx.conf, ctx.traffic, ctx.device, ctx.seed
    cfg = port_config(conf)
    ctx.mark("imports")
    sd = gen.make_weights(conf, seed, device, "float32")
    init = sd  # the program copies it; the reference starts from it again
    state = TrainState.create(port_model(cfg, sd, device), cfg, device=device)
    step = ctx.wrap_call(make_train_step(cfg, device=device))
    ctx.mark("state")
    cache, batches = dataset(conf, traffic, seed, device)
    ctx.mark("dataset")
    n = int(traffic["check_steps"])
    state, prog = program_readings(state, step, batches, cache, n)
    ctx.sync()
    ctx.mark("first steps")
    ctx.settle()
    rec = {"kind": "train", "setup_s": ctx.elapsed()}
    tr, t_slice, n_trace = None, None, int(traffic["trace_calls"])
    B = int(traffic["batch"])
    t0 = time.perf_counter()
    i = 0
    while True:
        if ctx.trace and tr is None and time.perf_counter() - t0 >= 0.2 * ctx.seconds:
            tr, t_slice = Slice(device).__enter__(), i
        state, _ = step(state, batches[(n + i) % len(batches)], cache)
        i += 1
        if tr is not None and tr.summary is None and i - t_slice == n_trace:
            tr.__exit__(None, None, None)
        if time.perf_counter() - t0 >= ctx.seconds and (tr is None or tr.summary is not None):
            break
    ctx.sync()
    rec.update(window_s=time.perf_counter() - t0, calls=i, images=i * B,
               peak_allocated=torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0)
    if tr is not None:
        rec["trace"] = dict(tr.summary, calls=n_trace, images=n_trace * B)
    ctx.close_window(rec)
    late_b = window_batches(batches, n + i, n)  # the feed goes on where the window left it
    state, start, late = late_readings(state, step, late_b, cache, n)
    del state, step
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_readings(conf, init, batches[:n], cache, device)
    numbers = judge.train_numbers(prog, ref, init)
    del ref
    ref_late = reference_readings(conf, init, late_b, cache, device, start=start)
    numbers.update(judge.train_numbers(late, ref_late, start["params"], prefix="late_", ema_init=start["ema"]))
    for key, losses in (("loss_gap", prog["loss"]), ("late_loss_gap", late["loss"])):
        if not all(math.isfinite(v) for v in losses):
            numbers[key] = float("nan")
    return {"rec": rec, "attempted": i, "failed": 0, "numbers": numbers}
