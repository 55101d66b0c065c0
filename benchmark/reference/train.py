"""The training step, plain PyTorch: targets, loss, Adamax and the EMA.

- Targets (reference: datasets/dataset_reader.py:215-291, with
  utils/data_utils.py:89-141): boxes to the stride-4 map, centres
  truncated toward zero, the CornerNet radius with the reference's quirk
  (r2 and r3 not divided by their quadratic coefficient), sigma
  ``(2r + 1) / 6``; the class heatmap the max over objects of a Gaussian
  cut to the square window |dx|, |dy| <= ceil(r), a noise object's centre
  0.9999; the eight projected corners of each 3D box (KITTI bottom-centre
  location, the intrinsics scaled to the map), truncated toward zero, their
  offsets, and which fall on the map.
- Loss (reference: models/rtm3d_loss.py:268-340, the dynamic form): the
  penalty-reduced focal term over the heatmap, L1 of the raw vertex
  offsets at the centres, of the sigmoid centre offsets and of the sigmoid
  vertex offsets at the vertices, weighted by the configuration's W_*.
- Adamax with coupled weight decay over the reference's three groups
  (solver/OptimizerBuilder.py:13-36): BatchNorm parameters (WEIGHT_DECAY_NORM),
  other biases (WEIGHT_DECAY_BIAS, lr x BIAS_LR_FACTOR), weights
  (WEIGHT_DECAY); the warm-up multistep schedule (solver/lr_scheduler.py),
  update t at the schedule's value at t. A parameter the loss does not
  reach gets a zero gradient, so weight decay still moves it.
- The EMA shadow of the parameters: ``d = EMA_DECAY * (1 - exp(-(t + 1) /
  2000))`` (module.py:71-119).

The KFPN and the header branches run as checkpointed segments, so that the
float32 step fits beside the frames: the same numbers, less memory.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference.inputs import photometric, warp

BETAS, ADAMAX_EPS = (0.9, 0.999), 1e-8


def gaussian_radius(h, w, min_overlap=0.7):
    b1 = h + w
    c1 = w * h * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt(torch.clamp(b1 ** 2 - 4 * c1, min=0.0))) / 2
    b2 = 2 * (h + w)
    c2 = (1 - min_overlap) * w * h
    r2 = (b2 + torch.sqrt(torch.clamp(b2 ** 2 - 16 * c2, min=0.0))) / 2
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (h + w)
    c3 = (min_overlap - 1) * w * h
    r3 = (b3 + torch.sqrt(torch.clamp(b3 ** 2 - 4 * a3 * c3, min=0.0))) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


def splat(m_proj, cls, sigma, radius, mask, noise, hw, num_classes):
    H, W = hw
    B, N = cls.shape
    dev = m_proj.device
    xs = torch.arange(W, device=dev).view(1, 1, W)
    ys = torch.arange(H, device=dev).view(1, H, 1)
    cls = cls.long().clamp(0, num_classes - 1)
    hm = torch.zeros((B, num_classes, H, W), device=dev)
    for n in range(N):
        dx = xs - m_proj[:, n, 0].long().view(B, 1, 1)
        dy = ys - m_proj[:, n, 1].long().view(B, 1, 1)
        rad = radius[:, n].view(B, 1, 1)
        sg = sigma[:, n].view(B, 1, 1)
        g = torch.where((dx.abs() <= rad) & (dy.abs() <= rad), torch.exp(-(dx * dx + dy * dy).float() / (2 * sg * sg)), 0.0)
        g = torch.where((noise[:, n] & mask[:, n]).view(B, 1, 1) & (dx == 0) & (dy == 0), 0.9999, g)
        g = torch.where(mask[:, n].view(B, 1, 1), g, 0.0)
        onehot = F.one_hot(cls[:, n], num_classes).bool().view(B, num_classes, 1, 1)
        hm = torch.maximum(hm, torch.where(onehot, g[:, None], 0.0))
    return hm


def project_corners(dim, loc, ry, K):
    """(N, 8, 2) image corners of boxes with a KITTI bottom-centre ``loc``."""
    h, w, l = dim[:, 0], dim[:, 1], dim[:, 2]
    signs = torch.tensor([[i, j, k] for i in (1, -1) for j in (1, -1) for k in (1, -1)], dtype=torch.float32,
                         device=dim.device)  # (8, 3)
    half = torch.stack([l, h, w], -1)[:, None, :] * 0.5 * signs[None]  # (N, 8, 3) x, y, z before the yaw
    c, s = torch.cos(ry)[:, None], torch.sin(ry)[:, None]
    X = c * half[..., 0] + s * half[..., 2] + loc[:, 0:1]
    Y = half[..., 1] + loc[:, 1:2] - h[:, None] * 0.5
    Z = -s * half[..., 0] + c * half[..., 2] + loc[:, 2:3]
    p = torch.einsum("nij,nkj->nki", K, torch.stack([X, Y, Z], -1))
    return p[..., :2] / (p[..., 2:3] + 1e-6)


def build_targets(labels: dict, hw, num_classes: int, down: float) -> dict:
    H, W = hw
    bbox = labels["bbox"].float() / down
    mask = labels["mask"].bool()
    centers = (bbox[..., 0:2] + bbox[..., 2:4]) * 0.5
    m_proj = centers.to(torch.int32)
    r = gaussian_radius(torch.ceil(bbox[..., 3] - bbox[..., 1]), torch.ceil(bbox[..., 2] - bbox[..., 0]))
    sigma = (2 * r + 1) / 6
    sigma = torch.where(mask & (sigma > 0), sigma, 1.0)
    radius = torch.where(mask, torch.ceil(r), 0.0)
    noise = labels["noise_mask"].bool()
    m_hm = splat(m_proj, labels["cls"], sigma, radius, mask, noise, (H, W), num_classes)
    B, N = mask.shape
    K = labels["K"].float().clone()
    K[..., :6] = K[..., :6] / down
    verts = project_corners(labels["dim"].float().reshape(-1, 3), labels["loc"].float().reshape(-1, 3),
                            labels["ry"].float().reshape(-1), K.reshape(-1, 3, 3)).reshape(B, N, 8, 2)
    v_proj = verts.to(torch.int32)
    return {
        "m_hm": m_hm.permute(0, 2, 3, 1), "m_proj": m_proj, "m_off": centers - m_proj,
        "v_proj": v_proj, "v_off": verts - v_proj, "v_coor_off": verts - centers[:, :, None, :],
        "v_mask": (v_proj[..., 0] >= 0) & (v_proj[..., 0] < W) & (v_proj[..., 1] >= 0) & (v_proj[..., 1] < H),
        "mask_3d": (labels["loc"][..., 2] > 0) & mask, "mask": mask, "noise_mask": noise,
    }


def loss(logits_nchw, t: dict, w) -> torch.Tensor:
    """The total loss: w[0] MKF + w[1] VFM + w[2] M_OFF + w[3] V_OFF."""
    m_hm_pred, vc_pred, mo_pred, vo_pred = (x.float().permute(0, 2, 3, 1) for x in logits_nchw)
    pred = torch.clamp(torch.sigmoid(m_hm_pred), 1e-4, 1 - 1e-4)
    tgt = t["m_hm"]
    pos, neg = tgt.eq(1).float(), tgt.lt(1).float()
    pl = torch.log(pred) * torch.pow(1 - pred, 2.0) * pos
    nl = torch.log(1 - pred) * torch.pow(pred, 2.0) * torch.pow(1 - tgt, 4.0) * neg
    npos = pos.sum()
    l_mkf = -nl.sum() if npos == 0 else -(pl.sum() + nl.sum()) / npos
    ofm_valid = t["mask"] & ~t["noise_mask"] & t["mask_3d"]
    Bt, Nt = t["mask"].shape
    bidx = torch.arange(Bt, device=tgt.device)[:, None].expand(Bt, Nt)
    mp = t["m_proj"][ofm_valid].long()
    vc = vc_pred[bidx[ofm_valid], mp[:, 1], mp[:, 0]].reshape(-1, 8, 2)
    exp = t["v_mask"][ofm_valid]
    l_vfm = F.l1_loss(vc[exp], t["v_coor_off"][ofm_valid][exp]) if exp.any() else vc.sum() * 0.0
    vsel = ofm_valid[..., None].expand(Bt, Nt, 8) & t["v_mask"]
    vp = t["v_proj"][vsel].long()
    vo = torch.sigmoid(vo_pred[bidx[..., None].expand(Bt, Nt, 8)[vsel], vp[:, 1], vp[:, 0]])
    l_voff = F.l1_loss(vo, t["v_off"][vsel]) if vsel.any() else vo_pred.sum() * 0.0
    msel = t["mask"] & ~t["noise_mask"]
    mp2 = t["m_proj"][msel].long()
    mo = torch.sigmoid(mo_pred[bidx[msel], mp2[:, 1], mp2[:, 0]])
    l_moff = F.l1_loss(mo, t["m_off"][msel]) if msel.any() else mo_pred.sum() * 0.0
    return w[0] * l_mkf + w[1] * l_vfm + w[2] * l_moff + w[3] * l_voff


def lr_at(solver: dict, t: int) -> float:
    """The warm-up multistep schedule at update ``t``."""
    f = 1.0
    if t < int(solver["WARMUP_ITERS"]):
        a = t / max(int(solver["WARMUP_ITERS"]), 1)
        f = float(solver["WARMUP_FACTOR"]) * (1 - a) + a
    return float(solver["BASE_LR"]) * f * float(solver["GAMMA"]) ** sum(t >= m for m in solver["STEPS"])


def param_groups(net: nn.Module, solver: dict) -> dict:
    """{name: (weight decay, lr factor)}."""
    norm = {id(p) for m in net.modules() if isinstance(m, nn.BatchNorm2d) for p in m.parameters(recurse=False)}
    out = {}
    for name, p in net.named_parameters():
        if id(p) in norm:
            out[name] = (float(solver["WEIGHT_DECAY_NORM"]), 1.0)
        elif name.endswith(".bias"):
            out[name] = (float(solver["WEIGHT_DECAY_BIAS"]), float(solver["BIAS_LR_FACTOR"]))
        else:
            out[name] = (float(solver["WEIGHT_DECAY"]), 1.0)
    return out


class Forward(nn.Module):
    """``net``'s forward with the KFPN and each header branch checkpointed."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, x):
        n = self.net
        z = checkpoint(n.kfpn_fusion, n.backbone(x), use_reentrant=False)
        head = n.detect_header
        return tuple(checkpoint(getattr(head, f"{b}_header"), z, use_reentrant=False)
                     for b in ("main_kf", "offset_fr_main", "main_offset", "vertex_offset"))


def steps(net: nn.Module, batches: list, cache: torch.Tensor, conf: dict, autocast=None, start=None) -> dict:
    """Train ``net`` (float32, train mode, on the cache's device) on each of
    ``batches`` in turn (the forward under ``torch.autocast`` to
    ``autocast`` when given: the witness of what bfloat16 alone does).
    ``start``, when given, is a state to go on from instead of the first
    update: {"t": updates so far, "params", "m", "u", "ema": {leaf: tensor}}.
    Returns the losses, the first update's gradient as
    Adamax takes it (weight decay added) and without the decay, and the
    parameters and the EMA shadow after the last update."""
    cfg = conf["config"]
    W_, H_ = cfg["INPUT_SIZE"]
    down = float(cfg["MODEL"]["DOWN_SAMPLE"])
    tr = cfg["TRAINING"]
    weights = (float(tr["W_MKF"]), float(tr["W_VFM"]), float(tr["W_M_OFF"]), float(tr["W_V_OFF"]))
    groups = param_groups(net, cfg["SOLVER"])
    params = dict(net.named_parameters())
    t0 = 0 if start is None else int(start["t"])
    if start is not None:
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(start["params"][k])
    m = {k: torch.zeros_like(p) if start is None else start["m"][k].clone() for k, p in params.items()}
    u = {k: torch.zeros_like(p) if start is None else start["u"][k].clone() for k, p in params.items()}
    ema = None
    if tr.get("EMA"):
        ema = {k: p.detach().clone() if start is None else start["ema"][k].clone() for k, p in params.items()}
    fwd = Forward(net)
    out = {"loss": []}
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for j, b in enumerate(batches):
            t = t0 + j
            dev = cache.device
            x = cache.index_select(0, torch.as_tensor(b["image_idx"], device=dev).long())
            x = photometric(x, torch.as_tensor(b["photo"], device=dev))
            x = warp(x, torch.as_tensor(b["warp"], device=dev), (H_, W_), cfg["DATASET"]["MEAN"],
                     cfg["DATASET"]["STD"], torch.as_tensor(b["border"], device=dev))
            labels = {k: torch.as_tensor(v, device=dev) for k, v in b["labels"].items()}
            targets = build_targets(labels, (H_ // int(down), W_ // int(down)), len(cfg["DATASET"]["OBJs"]), down)
            net.zero_grad(set_to_none=True)
            with torch.autocast(dev.type, dtype=autocast or torch.bfloat16, enabled=autocast is not None):
                logits = fwd(x.permute(0, 3, 1, 2).contiguous())
            total = loss(logits, targets, weights)
            total.backward()
            out["loss"].append(float(total.detach()))
            lr = lr_at(cfg["SOLVER"], t)
            with torch.no_grad():
                for k, p in params.items():
                    raw = p.grad if p.grad is not None else torch.zeros_like(p)
                    wd, factor = groups[k]
                    g = raw + wd * p
                    if j == 0:
                        out.setdefault("grad_raw", {})[k] = raw.clone()
                        out.setdefault("grad", {})[k] = g.clone()
                    m[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                    u[k] = torch.maximum(u[k] * BETAS[1], g.abs() + ADAMAX_EPS)
                    p.addcdiv_(m[k], u[k], value=-lr * factor / (1 - BETAS[0] ** (t + 1)))
                if ema is not None:
                    d = float(tr["EMA_DECAY"]) * (1.0 - math.exp(-(t + 1) / 2000.0))
                    for k, p in params.items():
                        ema[k].mul_(d).add_(p, alpha=1.0 - d)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    out["params"] = {k: p.detach().clone() for k, p in params.items()}
    out["ema"] = ema
    return out
