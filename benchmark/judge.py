"""The comparisons that decide ``correct``: the program's outputs against
the plain reference, number by number, each held to the cell's limit.

Detection (``detect_numbers``), for each call checked, on the program's own
outputs (cls, scores, valid, m_proj, v_proj, bbox2d, ry, dim, loc, cost,
accepted) and the reference's float32 logits of the same frames:

- ``score_gap``: the largest gap between a returned score and the
  reference's sigmoid score at the returned class and pixel;
- ``peak_gap`` (the 3x3 suppression): the largest amount by which a
  returned pixel lies below the best reference score in its 3x3
  neighbourhood; a returned reference peak reads 0;
- ``topk_gap`` (the top-K selection): of the reference's own top-K peaks
  whose place is sure (each stands above all eight neighbours by more than
  ``SURE``) and that have no returned pixel of their class within ``NEAR``
  map pixels, the largest amount by which one scores above the
  reference's K-th peak. On a ridge, where neighbours lie within rounding
  of each other, the maximum may move along it under bfloat16, so such
  peaks are not held to a place (PERF.md);
- ``vertex_gap_px``: the largest gap, in input pixels, between a returned
  vertex, centre or 2D box corner and the reference's, assembled from the
  reference's vertex and centre offsets at the returned pixel;
- ``accept_flip_pct``: the share of the detections above the score
  threshold whose ``valid`` or ``accepted`` bit is wrong: ``valid`` not
  score > SCORE_THRESH, ``accepted`` not valid and the returned cost <
  RESIDUAL_THRESH, or ``accepted`` against the reference's decision (the
  reference solving the program's returned vertices) where the
  reference's cost lies outside ``UNDECIDED`` of the threshold, a band
  several times the largest relative gap between the two costs near the
  threshold (PERF.md);
- ``solve_gap``: over detections both accept, the largest gap in the
  solution's seven numbers (location and dimensions in metres, yaw in
  radians, wrapped).

Notes beside them: ``cost_gap``, that relative gap of the costs near the
threshold, and the counts ``valid``, ``accepted`` and ``undecided``.

Training (``train_numbers``), over the first three steps of one train
state against the reference's three from the same weights and batches,
and with the prefix ``late_`` over three steps after the window against
the reference's three from the program's state as the window left it:

- ``loss_gap``: the largest relative gap of a step's loss
  (``loss_gap_first``, the first step's alone, is a note);
- ``change_gap``: the parameters' change over the three updates, each
  leaf's gap between the two norms over the larger of the reference's norm
  of that leaf and of the median leaf, and of those the median leaf's (the
  worst leaf's, ``change_gap_worst``, is a note);
- ``ema_gap``: the EMA shadow's change over the three updates, likewise.

The first update's gradient as the optimizer took it (weight decay added;
the program's from its Adamax state, ``exp_avg / (1 - beta1)``), measured
the same way, is a note (``grad_gap``): neither the control nor a fault of
the program reads ten times its readings, so it has no upper reading
(PERF.md). Which of these numbers a cell compares is its limits file's
choice; the rest are printed as notes.

Leaves whose reference gradient is under a thousandth of the median
leaf's (biases that feed BatchNorm, the residual projections DLA-34 drops)
move by weight decay and round-off alone and are left out of the two
changes.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import decode as ref_decode

EXCLUDE_BELOW = 1e-3  # of the median leaf's reference gradient norm
NEAR = 3  # map pixels within which a returned peak stands for a reference peak
SURE = 0.004  # a reference peak whose place is sure stands above each neighbour by more than this
UNDECIDED = 0.002  # relative band about RESIDUAL_THRESH in which the reference's accept decision is not held


def _pixels(m_proj: torch.Tensor, sub: torch.Tensor, down: float, W: int, H: int):
    """The map pixel of each returned centre, m_proj = (pixel + sigmoid) x
    down. Where the sigmoid rounded to 0 or 1 the quotient is a whole
    number and the pixel is it or the one before: of the candidates, the
    one whose reference centre offset (``sub``, (B, 2, H, W) sigmoids)
    puts the centre nearest to what was returned."""
    q = m_proj.double() / down
    base = torch.floor(q).long()
    best, err = None, None
    for dx in (0, -1):
        for dy in (0, -1):
            x = (base[..., 0] + dx).clamp(0, W - 1)
            y = (base[..., 1] + dy).clamp(0, H - 1)
            b = torch.arange(x.shape[0], device=x.device)[:, None].expand_as(x)
            pred = torch.stack([x, y], -1).double() + sub[b, :, y, x].double()
            e = (pred - q).abs().sum(-1)
            if best is None:
                best, err = (x, y), e
            else:
                take = e < err
                best = (torch.where(take, x, best[0]), torch.where(take, y, best[1]))
                err = torch.where(take, e, err)
    return best


def detect_numbers(out: dict, logits, K: torch.Tensor, conf: dict) -> dict:
    """The numbers of one call. ``out``: the program's outputs as
    numpy arrays; ``logits``: the reference's 4 NCHW maps; ``K`` (B, 3, 3)."""
    d = conf["config"]["DETECTOR"]
    down = float(conf["config"]["MODEL"]["DOWN_SAMPLE"])
    thresh, rthresh = float(d["SCORE_THRESH"]), float(d["RESIDUAL_THRESH"])
    dev = logits[0].device
    o = {k: torch.as_tensor(np.asarray(v), device=dev) for k, v in out.items()}
    kf, vc, mo, _ = (x.float() for x in logits)
    B, C, H, W = kf.shape
    topk = o["cls"].shape[1]
    hm, peaks = ref_decode.heatmap(kf)
    x, y = _pixels(o["m_proj"], torch.sigmoid(mo), down, W, H)
    c = o["cls"].long().clamp(0, C - 1)
    b = torch.arange(B, device=dev)[:, None].expand(B, topk)
    ref_score = hm[b, c, y, x]
    score_gap = (o["scores"].float() - ref_score).abs().max()

    hmax = F.max_pool2d(hm, 3, stride=1, padding=1)
    below = hmax[b, c, y, x] - ref_score  # how far each returned pixel lies below a reference peak beside it
    returned = torch.zeros((B, C, H, W), device=dev)
    returned[b, c, y, x] = 1.0
    covered = F.max_pool2d(returned, 2 * NEAR + 1, stride=1, padding=NEAR) > 0
    top_s, top_i = torch.topk(peaks.reshape(B, -1), topk, dim=1)  # the reference's own top-K
    in_top = torch.zeros(B, C * H * W, dtype=torch.bool, device=dev).scatter_(1, top_i, True).reshape(B, C, H, W)
    pad = F.pad(hm, (1, 1, 1, 1), value=-1.0)
    nbr = torch.stack([pad[:, :, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W] for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                       if dy or dx]).amax(0)  # each pixel's best neighbour
    sure = in_top & (peaks - nbr > SURE)
    missed = sure & ~covered
    topk_gap = torch.where(missed, peaks - top_s[:, -1][:, None, None, None], 0.0).max()

    cen = torch.stack([x, y], -1).float() + torch.sigmoid(mo[b, :, y, x])
    v_ref = (vc[b, :, y, x].reshape(B, topk, 8, 2) + cen[:, :, None, :]) * down
    box_ref = torch.cat([v_ref.amin(2), v_ref.amax(2)], -1)
    vgaps = torch.stack([(o["v_proj"].float() - v_ref).abs().amax(), (o["m_proj"].float() - cen * down).abs().amax(),
                         (o["bbox2d"].float() - box_ref).abs().amax()])

    sol = ref_decode.solve3d(o["v_proj"].float(), o["cls"], K[:, None].expand(B, topk, 3, 3).float(), d)
    valid = o["scores"].float() > thresh
    want = valid & (sol["cost"] < rthresh)
    decided = (sol["cost"] < rthresh / (1 + UNDECIDED)) | (sol["cost"] > rthresh * (1 + UNDECIDED))
    own = o["valid"].bool() & (o["cost"].float() < rthresh)  # the answer's decision from its own cost
    flips = (o["valid"].bool() != valid) | (o["accepted"].bool() != own) | (decided & (o["accepted"].bool() != want))
    flip_pct = 100.0 * flips.sum().float() / valid.sum().clamp(min=1)
    both = o["accepted"].bool() & want
    dry = torch.remainder(o["ry"].float() - sol["ry"] + math.pi, 2 * math.pi) - math.pi
    gaps = torch.cat([(o["loc"].float() - sol["loc"]).abs(), (o["dim"].float() - sol["dim"]).abs(), dry.abs()[..., None]], -1)
    solve_gap = gaps[both].max() if both.any() else torch.zeros((), device=dev)
    c_r = sol["cost"]
    near_thresh = valid & (c_r > rthresh / 2) & (c_r < rthresh * 2)
    cost_gap = torch.where(near_thresh, (o["cost"].float() - c_r).abs() / c_r, 0.0).max()
    return {"score_gap": float(score_gap), "peak_gap": float(below.max()), "topk_gap": float(topk_gap),
            "vertex_gap_px": float(vgaps.max()),
            "accept_flip_pct": float(flip_pct), "solve_gap": float(solve_gap),
            "cost_gap": float(cost_gap), "valid": int(valid.sum()), "accepted": int(want.sum()),
            "undecided": int((valid & ~decided).sum())}


def _leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """{leaf: |norm(prog) - norm(ref)| / max(norm(ref), the median leaf's norm(ref))}."""
    names = [k for k in ref if keep is None or k in keep]
    pn = {k: float(prog[k].double().norm()) for k in names}
    rn = {k: float(ref[k].double().norm()) for k in names}
    med = float(np.median([rn[k] for k in names]))
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in names}


def train_numbers(prog: dict, ref: dict, init: dict, prefix: str = "", ema_init: dict | None = None) -> dict:
    """``prog`` and ``ref``: {"loss": [floats], "grad": {leaf: first
    gradient with decay} (the program's only from the seed), "params":
    {leaf: after the last}, "ema": {...}}; ``ref`` also has "grad_raw";
    ``init``: the leaves before the first update, ``ema_init`` the EMA's
    (``init`` when not given). Each number's name takes ``prefix``. The
    compared numbers are the median leaf's gaps; the worst leaf's are notes
    (PERF.md: under bfloat16 the worst first gradient is a BatchNorm
    parameter of the stem, and the worst change a convolution's weight of
    the stem, the first level or the KFPN's transposed convolutions, where
    the reference under bfloat16 autocast reads as far)."""
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["loss"], ref["loss"]))
    raw = {k: float(v.double().norm()) for k, v in ref["grad_raw"].items()}
    med = float(np.median(list(raw.values())))
    keep = {k for k, v in raw.items() if v >= EXCLUDE_BELOW * med}
    change = lambda s, base: {k: s[k].double() - base[k].double() for k in ref["params"]}
    gaps = {"change": _leaf_gaps(change(prog["params"], init), change(ref["params"], init), keep)}
    if "grad" in prog:
        gaps["grad"] = _leaf_gaps(prog["grad"], ref["grad"])
    if ref.get("ema") is not None:
        base = init if ema_init is None else ema_init
        gaps["ema"] = _leaf_gaps(change(prog["ema"], base), change(ref["ema"], base), keep)
    out = {f"{prefix}loss_gap": loss_gap,
           f"{prefix}loss_gap_first": abs(prog["loss"][0] - ref["loss"][0]) / abs(ref["loss"][0])}
    for name, g in gaps.items():
        worst = max(g, key=g.get)
        out[f"{prefix}{name}_gap"] = float(np.median(list(g.values())))
        out[f"{prefix}{name}_gap_worst"] = g[worst]
        out[f"{prefix}{name}_worst_leaf"] = worst
    out[f"{prefix}leaves_left_out"] = len(raw) - len(keep)
    return out
