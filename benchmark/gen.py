"""What a run is fed, made from ``--seed``: weights, frames, labels, batches.

The same seed gives the same inputs; every seed gives the same sizes (batch,
frames, objects padded to MAX_OBJS), so seeds change values, not work.

- Weights: one uniform draw on the device from a ``torch.Generator`` there,
  cut into the network's tensors and scaled by the init's bound (xavier-
  uniform convolutions, U(+-1/sqrt(fan_in)) biases, U(+-sqrt(3/(out k k)))
  transposed convolutions with the bilinear fill of output channel 0;
  BatchNorm weight 1, bias 0, statistics 0 and 1), rounded to the dtype the
  network is served in. The vertex head can be set to draw a car (zero
  weights, a cuboid's offsets as bias), so that the 3D solve converges and
  the accept decision has something to decide, and the heatmap and
  centre-offset heads can be given a gain (``scale_heads``).
- Frames: uint8, made on the device (a coarse random field upsampled,
  plus noise) and copied to host memory, where a user's frames live.
- Labels: KITTI-like objects (Car / Pedestrian / Cyclist 82 / 13 / 5%,
  a Poisson count of mean ``objects_per_frame``, 3D boxes 5-60 m ahead,
  dimensions about the class priors, any yaw), projected to the input
  frame for their 2D boxes, padded to MAX_OBJS; about a tenth flagged as
  noise objects.
"""

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.network import build_network

K_KITTI = np.array([[721.5377, 0.0, 609.5593], [0.0, 721.5377, 172.854], [0.0, 0.0, 1.0]], np.float32)
CLASS_SHARE = (0.82, 0.13, 0.05)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
VERTEX_HEAD = "detect_header.offset_fr_main_header.offset_fr_main_head"


def stream(seed: int, salt: int) -> int:
    """A sub-seed of ``seed`` for one use, in [0, 2^63)."""
    return (int(seed) * 1000003 + salt * 7919 + 12345) % (2 ** 63)


def device_generator(seed: int, salt: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream(seed, salt))


def host_rng(seed: int, salt: int) -> np.random.Generator:
    return np.random.default_rng(stream(seed, salt))


def _bilinear_1d(k: int) -> torch.Tensor:
    f = math.ceil(k / 2)
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    return torch.tensor([1 - abs(i / f - c) for i in range(k)], dtype=torch.float32)


def make_weights(conf: dict, seed: int, device, dtype: str) -> dict:
    """The configuration's network's state dict, float32 tensors on
    ``device`` holding values of ``dtype``."""
    with torch.device("meta"):
        net = build_network(conf)
    sd = net.state_dict()
    bounds, fills = {}, {}
    for name, m in net.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(m, nn.ConvTranspose2d):
            _, out_ch, kh, kw = m.weight.shape
            bounds[pre + "weight"] = math.sqrt(3.0 / (out_ch * kh * kw))
            fills[pre + "weight"] = torch.outer(_bilinear_1d(kh), _bilinear_1d(kw))
        elif isinstance(m, nn.Conv2d):
            k = m.weight.shape[2] * m.weight.shape[3]
            fan_in, fan_out = m.in_channels * k, m.out_channels * k
            bounds[pre + "weight"] = math.sqrt(6.0 / (fan_in + fan_out))
            if m.bias is not None:
                bounds[pre + "bias"] = 1.0 / math.sqrt(fan_in)
    names = list(bounds)
    sizes = [sd[n].numel() for n in names]
    flat = torch.rand(sum(sizes), generator=device_generator(seed, 1, device), device=device) * 2.0 - 1.0
    out = {}
    for n, part in zip(names, torch.split(flat, sizes)):
        w = part.reshape(sd[n].shape) * bounds[n]
        if n in fills:
            w[:, 0] = fills[n].to(device)
        out[n] = w
    for n, t in sd.items():
        if n in out:
            continue
        if n.endswith("running_var") or (n.endswith("weight") and t.dim() == 1):
            out[n] = torch.ones(t.shape, device=device)
        elif n.endswith("num_batches_tracked"):
            out[n] = torch.zeros(t.shape, dtype=torch.long, device=device)
        else:
            out[n] = torch.zeros(t.shape, device=device)
    cast = DTYPES[dtype]
    return {n: t.to(cast).to(t.dtype) if t.is_floating_point() else t for n, t in out.items()}


def car_vertex_bias(K: np.ndarray, depth: float, down: float) -> np.ndarray:
    """(16,) vertex offsets in map pixels, (dx, dy) per corner in the
    solver's corner order: a car (1.53, 1.63, 3.88) at yaw 0.4, ``depth`` m
    ahead on the optical axis, projected relative to its centre."""
    h, w, l, ry = 1.53, 1.63, 3.88, 0.4
    c, s = math.cos(ry), math.sin(ry)
    out = []
    for i in (1, -1):
        for j in (1, -1):
            for k in (1, -1):
                x, y = i * l / 2 * c + k * w / 2 * s, j * h / 2
                z = -i * l / 2 * s + k * w / 2 * c + depth
                out += [K[0, 0] * x / z / down, K[1, 1] * y / z / down]
    return np.array(out, np.float32)


def draw_car(sd: dict, K: np.ndarray, depth: float, down: float, dtype: str) -> dict:
    """``sd`` with its vertex head's output constant: a car's cuboid."""
    sd[VERTEX_HEAD + ".weight"].zero_()
    bias = torch.from_numpy(car_vertex_bias(K, depth, down)).to(sd[VERTEX_HEAD + ".bias"].device)
    sd[VERTEX_HEAD + ".bias"].copy_(bias.to(DTYPES[dtype]).float())
    return sd


def scale_heads(sd: dict, gains: dict, dtype: str) -> dict:
    """``sd`` with the output conv of each header branch named in ``gains``
    multiplied by its gain (and rounded to ``dtype`` again): random weights
    give logits whose spread over pixels and frames is a few hundredths, so
    the heatmap would be nearly flat and any frame's answers near any
    other's; the gain spreads the scores and the centre offsets as a
    trained network's are spread."""
    for name, gain in gains.items():
        w = sd[f"detect_header.{name}_header.{name}_head.weight"]
        w.copy_((w * float(gain)).to(DTYPES[dtype]).float())
    return sd


def warp_params(src_hw, out_wh, resize_max_side: int, scale: float = 1.0, mirror: bool = False):
    """(sx, sy, tx, ty) of resize -> scale -> mirror -> centre pad, and the
    matching 2x3 affine (the reader's composition)."""
    h0, w0 = src_hw
    sw, sh = out_wh
    r = resize_max_side / max(h0, w0)
    nw, nh = int(w0 * r), int(h0 * r)
    s_eff = r * scale
    tx, ty = nw * (1 - scale) / 2.0, nh * (1 - scale) / 2.0
    sx = s_eff
    if mirror:
        sx, tx = -s_eff, nw - tx
    tx += (sw - nw) // 2
    ty += (sh - nh) // 2
    return np.array([sx, s_eff, tx, ty], np.float32), np.array([[sx, 0, tx], [0, s_eff, ty]], np.float64)


def frames(seed: int, salt: int, n: int, hw, device, chunk: int = 64) -> torch.Tensor:
    """``n`` uint8 (H, W, 3) frames on ``device``: a 1/16-scale random field
    upsampled bilinearly, plus noise."""
    H, W = hw
    g = device_generator(seed, salt, device)
    out = torch.empty((n, H, W, 3), dtype=torch.uint8, device=device)
    for a in range(0, n, chunk):
        b = min(n, a + chunk)
        coarse = torch.rand((b - a, 3, max(2, H // 16), max(2, W // 16)), generator=g, device=device) * 255.0
        x = F.interpolate(coarse, size=(H, W), mode="bilinear", align_corners=False)
        x = x + torch.randn(x.shape, generator=g, device=device) * 12.0
        out[a:b] = x.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
    return out


def kitti_K(canvas_hw) -> np.ndarray:
    """KITTI's intrinsics (a 375x1242 frame) scaled to a ``canvas_hw`` camera
    frame: the same camera, fewer pixels."""
    K = K_KITTI.astype(np.float64).copy()
    K[0] *= canvas_hw[1] / 1242.0
    K[1] *= canvas_hw[0] / 375.0
    return K.astype(np.float32)


def input_K(K: np.ndarray, params: np.ndarray) -> np.ndarray:
    """The intrinsics of a frame warped by (sx, sy, tx, ty), mirror ignored."""
    sx, sy, tx, ty = (float(v) for v in params[:4])
    Ki = K.astype(np.float64).copy()
    Ki[0] *= abs(sx)
    Ki[1] *= sy
    Ki[0, 2] += tx if sx > 0 else 0.0
    Ki[1, 2] += ty
    return Ki.astype(np.float32)


def labels(rng: np.random.Generator, B: int, max_objs: int, mean_objs: float, K_in: np.ndarray, out_wh,
           dim_ref) -> dict:
    """A (B, max_objs) label block in the input frame of intrinsics
    ``K_in`` (B, 3, 3)."""
    W, H = out_wh
    dim_ref = np.asarray(dim_ref, np.float64)
    blk = {"cls": np.zeros((B, max_objs), np.int32), "bbox": np.zeros((B, max_objs, 4), np.float32),
           "dim": np.zeros((B, max_objs, 3), np.float32), "alpha": np.zeros((B, max_objs), np.float32),
           "ry": np.zeros((B, max_objs), np.float32), "loc": np.zeros((B, max_objs, 3), np.float32),
           "K": np.tile(K_in.reshape(B, 1, 9), (1, max_objs, 1)).astype(np.float32),
           "mask": np.zeros((B, max_objs), bool), "noise_mask": np.zeros((B, max_objs), bool)}
    signs = np.array([[i, j, k] for i in (1, -1) for j in (1, -1) for k in (1, -1)], np.float64)
    for b in range(B):
        want = min(max_objs, int(rng.poisson(mean_objs)))
        K = K_in[b].astype(np.float64)
        n = tries = 0
        while n < want and tries < 50 * max_objs:
            tries += 1
            c = int(rng.choice(3, p=CLASS_SHARE))
            h, w, l = dim_ref[c] * (1.0 + 0.08 * rng.standard_normal(3))
            z = rng.uniform(5.0, 60.0)
            u = rng.uniform(0.05 * W, 0.95 * W)
            x = (u - K[0, 2]) * z / K[0, 0]
            y = 1.65 + 0.1 * rng.standard_normal()
            ry = rng.uniform(-math.pi, math.pi)
            half = signs * np.array([l, h, w]) * 0.5
            X = math.cos(ry) * half[:, 0] + math.sin(ry) * half[:, 2] + x
            Y = half[:, 1] + y - h * 0.5
            Z = -math.sin(ry) * half[:, 0] + math.cos(ry) * half[:, 2] + z
            if Z.min() < 1.0:
                continue
            uv = (K @ np.stack([X, Y, Z]))[:2] / Z
            x1, y1 = max(0.0, uv[0].min()), max(0.0, uv[1].min())
            x2, y2 = min(W - 1.0, uv[0].max()), min(H - 1.0, uv[1].max())
            if min(x2 - x1, y2 - y1) < 4.0 * W / 1280.0:  # 4 px at 1280 wide
                continue
            blk["cls"][b, n] = c
            blk["bbox"][b, n] = (x1, y1, x2, y2)
            blk["dim"][b, n] = (h, w, l)
            blk["ry"][b, n] = ry
            blk["alpha"][b, n] = ry - math.atan2(x, z)
            blk["loc"][b, n] = (x, y, z)
            blk["mask"][b, n] = True
            blk["noise_mask"][b, n] = rng.random() < 0.1
            n += 1
    return blk
