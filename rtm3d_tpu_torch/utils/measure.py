"""What the measurements of the port on a GPU share (``chip_smoke.py``):
the card's peak rates, the timers, the detect and train paths' shapes and
their synthetic inputs, the LM kernel's agreement with its plain version,
and a train state's tensors for a bit-for-bit comparison.

It imports torch and numpy and nothing of this package, so a process that
imports another version of ``rtm3d_tpu_torch`` (``chip_smoke.py
--kernel-ab``) can keep it.
"""

from __future__ import annotations

import os
import subprocess
import sys

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
PEAK_INT8_OPS = 1979e12  # dense, tensor cores
PROFILER_SESSIONS = 3  # kernel_device_ms: profiler sessions before it times by a CUDA graph


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


def kernel_device_ms(fn, reps: int, kernel: str) -> tuple[float, str]:
    """Mean device milliseconds of the kernels whose name holds ``kernel``
    over ``reps`` calls of ``fn()``, and what timed them: ``"profiler"``
    (torch.profiler, the kernels alone) or ``"graph"``.

    Now and then a profiler session records no device activity at all
    (seen on an H100 in 2 of 8 long runs, each time in a process that had
    run many sessions and forked loader workers): such a session is
    reported on stderr and the measurement is taken again, in up to
    PROFILER_SESSIONS sessions; then the time is ``graph_device_ms``'s,
    which includes the gaps between launches, and the second value says
    so."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for session in range(1, PROFILER_SESSIONS + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        rows = [e for e in events if kernel in e.key]
        if rows:
            return sum(e.self_device_time_total for e in rows) / sum(e.count for e in rows) / 1e3, "profiler"
        print(f"kernel_device_ms: profiler session {session} of {PROFILER_SESSIONS} saw no {kernel} launch "
              f"({len(events)} device rows: {[e.key[:60] for e in events[:5]]})", file=sys.stderr, flush=True)
    return graph_device_ms(fn, reps), "graph"


def graph_device_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` calls captured in
    one CUDA graph and replayed between CUDA events: no host work between
    the launches, so it measures the kernels and the gaps between them
    (``fn`` must launch on the current stream and not synchronise)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the default stream, as capture wants
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def int_mm_conv(xq: torch.Tensor, w: torch.Tensor, stride: int, padding: int, dilation: int) -> torch.Tensor:
    """The library yardstick of the int8 convolution: im2col by ``F.unfold``
    (on float16 copies of the int8 values: unfold takes no integer type) and
    cuBLASLt's int8 GEMM ``torch._int_mm``; the int32 sums, (N*Ho*Wo, Cout).
    xq (N, H, W, C) int8, w (Cout, Cin <= C, KH, KW) int8 (channels past Cin
    are zero in xq). ``_int_mm`` wants K and N multiples of 8 and M > 16:
    both are zero-padded."""
    c = xq.shape[-1]
    cout, cin, kh, kw = w.shape
    w = torch.nn.functional.pad(w, (0, 0, 0, 0, 0, c - cin))
    cols = torch.nn.functional.unfold(xq.permute(0, 3, 1, 2).half(), (kh, kw), dilation=dilation, padding=padding,
                                      stride=stride)  # (N, C*KH*KW, L)
    k = cols.shape[1]
    kp, npad = -(-k // 8) * 8, -(-cout // 8) * 8
    a = torch.nn.functional.pad(cols.transpose(1, 2).reshape(-1, k), (0, kp - k)).to(torch.int8)
    b = torch.zeros((npad, kp), dtype=torch.int8, device=w.device)
    b[:cout, :k] = w.reshape(cout, k)
    return torch._int_mm(a, b.t())[:, :cout]


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


def state_tensors(state) -> dict:
    """Every tensor and counter of a train state, copied: parameters and BN
    buffers, the optimizer's state and hyperparameters, the EMA shadow,
    step and updates."""
    out = {f"model.{k}": v.detach().clone() for k, v in state.model.state_dict().items()}
    opt = state.optimizer.state_dict()
    for i, st in opt["state"].items():
        out.update({f"opt.{i}.{k}": v.clone() if torch.is_tensor(v) else v for k, v in st.items()})
    for i, group in enumerate(opt["param_groups"]):
        out[f"opt.group{i}"] = {k: v for k, v in group.items()}
    out.update({f"ema.{k}": v.clone() for k, v in (state.ema or {}).items()})
    out["step"], out["updates"] = state.step, state.updates
    return out


def unequal(a: dict, b: dict) -> list:
    """Keys of two ``state_tensors`` whose values differ in any bit, dtype
    or device, or that only one side has."""
    bad = sorted(set(a) ^ set(b))
    for k in sorted(set(a) & set(b)):
        x, y = a[k], b[k]
        same = (x.dtype == y.dtype and x.device == y.device and torch.equal(x, y)) if torch.is_tensor(x) else x == y
        if not same:
            bad.append(k)
    return bad


def cuboid_vertex_bias(K, down: float = 4.0, depth: float = 25.0, row: float | None = None) -> np.ndarray:
    """(16,) vertex offsets in feature pixels, (dx, dy) per vertex in the LM
    solver's corner order: a car (h, w, l) = (1.53, 1.63, 3.88) at yaw 0.4,
    centred ``depth`` m ahead on the ray through the principal column and
    feature row ``row`` of K (the optical axis when None), projected
    relative to its centre. As the constant output of the vertex head
    (``offset_fr_main``, zero weights) it makes every peak regress a
    near-cuboid (exact at that point), on which the LM converges to a
    plausible box, where the vertices of random weights fit no cuboid and
    leave the solve unconverged. Elsewhere the pattern is a cuboid's only
    up to perspective, so the LM accepts it (cost < 0.1) only near that
    row: a farther car, drawing a smaller pattern, widens the band."""
    h, w, l, ry, z0 = 1.53, 1.63, 3.88, 0.4, float(depth)
    dv = 0.0 if row is None else row * down - K[1, 2]  # the centre's rows below the principal point
    y0 = dv * z0 / K[1, 1]
    c, s = np.cos(ry), np.sin(ry)
    out = []
    for i in (1, -1):
        for j in (1, -1):
            for k in (1, -1):
                x, y = i * l / 2 * c + k * w / 2 * s, j * h / 2 + y0
                z = -i * l / 2 * s + k * w / 2 * c + z0
                out += [K[0, 0] * x / z / down, (K[1, 1] * y / z - dv) / down]
    return np.array(out, np.float32)


def _result_lines(path: str) -> list:
    with open(path) as f:
        return [(p[0], np.array(p[1:], np.float64)) for p in (l.split() for l in f.read().splitlines()) if p]


def reprojection_px(results_dir: str, names, tree: str) -> dict:
    """Each KITTI result line's 3D box (h, w, l, bottom-centre location,
    ry) projected with its frame's K (calib P2's 3x3, the solver's camera),
    the box of its 8 corners clipped to the frame as the detect CLI clips,
    against the line's 2D box, the box of the decoded vertices: the line
    count and the largest |difference| in pixels. A 3D box that fits the
    vertices (an accepted solve) projects onto that box, whichever solver
    found it; a wrong one does not."""
    from PIL import Image

    from rtm3d_tpu_torch.data.kitti import parse_calib_file

    n, worst = 0, 0.0
    for name in names:
        K = parse_calib_file(f"{tree}/training/calib/{name}.txt").reshape(3, 3).astype(np.float64)
        image = [f for f in os.listdir(f"{tree}/training/image_2") if os.path.splitext(f)[0] == name][0]
        w0, h0 = Image.open(f"{tree}/training/image_2/{image}").size
        for _, v in _result_lines(f"{results_dir}/{name}.txt"):
            h, w, l = v[7:10]
            c, s = np.cos(v[13]), np.sin(v[13])
            x = l / 2 * np.array([1, 1, -1, -1, 1, 1, -1, -1])
            y = -h * np.array([0, 0, 0, 0, 1, 1, 1, 1])
            z = w / 2 * np.array([1, -1, -1, 1, 1, -1, -1, 1])
            corners = np.stack([c * x + s * z, y, -s * x + c * z]) + v[10:13, None]
            uv = K @ corners
            u, vv = uv[0] / uv[2], uv[1] / uv[2]
            box = np.array([u.min(), vv.min(), u.max(), vv.max()])
            box[0::2], box[1::2] = box[0::2].clip(0, w0 - 1), box[1::2].clip(0, h0 - 1)
            worst = max(worst, float(np.abs(box - v[3:7]).max()))
            n += 1
    return {"lines": n, "max_px": worst}


def compare_result_dirs(want_dir: str, got_dir: str, names) -> dict:
    """Two directories of KITTI result files, line against line: each line
    of ``want_dir`` is matched to the line of ``got_dir`` of its image and
    class with the nearest 2D box. Returns the line counts, the share of
    matched lines whose box agrees to the format's last digit (0.01), and
    the largest |difference| per field group: box, score, angle (alpha and
    ry, wrapped), dim, loc; the share whose pose agrees to the format's
    last digit (angles and dim within 0.01, loc within 0.05, the tolerances
    of the port's CPU tests against the JAX package); the largest score
    |difference| of the lines whose box agrees (``agreed_score``: a line on
    one side only is matched to another detection); and the depths of the
    matched lines."""
    n_want = n_got = within = pose_within = 0
    agreed_score = 0.0
    worst = {"box": 0.0, "score": 0.0, "angle": 0.0, "dim": 0.0, "loc": 0.0}
    depth = []
    for name in names:
        want, got = _result_lines(f"{want_dir}/{name}.txt"), _result_lines(f"{got_dir}/{name}.txt")
        n_want, n_got = n_want + len(want), n_got + len(got)
        for cls, w in want:
            cands = [g for c, g in got if c == cls]
            if not cands:
                worst["box"] = float("inf")
                continue
            g = min(cands, key=lambda v: np.abs(v[3:7] - w[3:7]).max())
            box = float(np.abs(g[3:7] - w[3:7]).max())
            within += box <= 0.01 + 1e-9
            if box <= 0.01 + 1e-9:
                agreed_score = max(agreed_score, float(abs(g[14] - w[14])))
            d = {"box": box, "score": float(abs(g[14] - w[14])),
                 "angle": float(np.abs(np.angle(np.exp(1j * (g[[2, 13]] - w[[2, 13]])))).max()),
                 "dim": float(np.abs(g[7:10] - w[7:10]).max()), "loc": float(np.abs(g[10:13] - w[10:13]).max())}
            worst = {k: max(worst[k], d[k]) for k in worst}
            pose_within += d["angle"] <= 0.01 + 1e-9 and d["dim"] <= 0.01 + 1e-9 and d["loc"] <= 0.05
            depth.append(float(w[12]))
    return {"lines": n_want, "lines_got": n_got, "box_agree_share": within / max(n_want, 1),
            "pose_agree_share": pose_within / max(n_want, 1), "max_abs": worst, "agreed_score": agreed_score,
            "depth_range": [min(depth), max(depth)] if depth else None}
