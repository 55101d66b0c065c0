"""Candidate-level diagnosis of the same-weights production-gate AP delta.

Port of ``tools/diag_same_weights.py`` (:29-172). ``ap_parity
--production`` pushes one trained checkpoint through the port's pipeline
and the reference pipeline and scores AP; when the columns disagree, this
tool says where the pipelines part. It reads ``port_final.pt`` and
``kitti/`` from a work dir, runs the port's detect step over the eval split
(fp32, TF32 off: the LM kernel's two launches a batch), runs the reference
decode (``reference_pipeline.reference_decode``, the network in fp32 on
the host) on the same frames, matches candidates on (class, heatmap peak
cell), and for each matched candidate solves the reference's scipy fit
(``reference_solve``):

    score_j vs score_t      -> the forward pass's numerics
    dvert                   -> the decode's (max |vertex| difference, px)
    cost_lm vs cost_scipy   -> the solvers' fits
    acc_j vs acc_t          -> residual < RESIDUAL_THRESH gate flips

The summary and the rows carry the JAX tool's keys; their ``jax``/``_j``
names the framework's pipeline, here the port's. Each row also holds the
port's vertices (``v_proj``) and the frame's ``K``: what the LM solved,
which ``solver_tune`` solves again. ``cost_lm_minus_scipy_pct``
holds percentiles of the cost difference (despite its name, not percents).
``--out`` writes ``{"summary", "rows", "config"}``; ``config`` adds the
card, the seconds and the LM's launches.

    python -m rtm3d_tpu_torch.tools.diag_same_weights --work-dir DIR [--input-size 512] [--batch 8]
        [--eval-split train] [--backbone RESNET-18] [--bf16] [--out diag.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import time

import numpy as np
import torch

from rtm3d_tpu_torch.data.kitti import create_dataset
from rtm3d_tpu_torch.data.loader import DataLoader
from rtm3d_tpu_torch.nn.model import create_model
from rtm3d_tpu_torch.ops import lm_solver
from rtm3d_tpu_torch.tools.ap_parity import BACKBONES, _card, make_config, tf32_mode
from rtm3d_tpu_torch.tools.reference_pipeline import reference_decode, reference_solve
from rtm3d_tpu_torch.train.step import make_detect_step, resolve_device


def load_work_dir(work_dir: str, input_size: int, batch: int, eval_split: str, backbone: str = "RESNET-18",
                  bf16: bool = False) -> tuple:
    """(config, the trained model, the eval split) of a production work
    dir: ``make_config`` of its fixture, ``port_final.pt`` loaded, the
    split's rect size as the input size."""
    data = os.path.join(work_dir, "kitti")
    cfg = make_config(data, input_size, batch, 1e-3, backbone)
    if bf16:
        cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    ds = create_dataset(data, cfg, is_training=False, split=eval_split)
    cfg.INPUT_SIZE = tuple(ds.img_size)
    model = create_model(cfg)
    model.load_state_dict(torch.load(os.path.join(work_dir, "port_final.pt"), map_location="cpu",
                                     weights_only=True))
    return cfg, model.eval(), ds


def _name(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def port_detections(cfg, model, ds, batch: int, device) -> dict:
    """{frame name: that frame's detections, numpy} of the port's detect
    step over ``ds`` (a padded final batch; its pads dropped)."""
    detect = make_detect_step(model, cfg, with_3d=True, device=device)
    loader = DataLoader(ds, min(batch, len(ds)), shuffle=False, drop_last=False, pad_final=True)
    out = {}
    for b in loader:
        det = detect(b["image"].astype(np.float32), b["calib"].reshape(-1, 3, 3).astype(np.float32))
        det = {k: v.cpu().numpy() for k, v in det.items()}
        for bi in range(int(b["num_valid"])):
            out[_name(b["path"][bi])] = {k: v[bi] for k, v in det.items()}
    return out


def diagnose(cfg, model, ds, batch: int, device) -> dict:
    """``{"summary", "rows"}`` as the JAX tool computes them (:64-159)."""
    down = float(cfg.MODEL.DOWN_SAMPLE)
    thresh = float(cfg.DETECTOR.SCORE_THRESH)
    res_thresh = float(cfg.DETECTOR.RESIDUAL_THRESH)
    topk = int(cfg.DETECTOR.TOPK_CANDIDATES)
    with tf32_mode(False):
        port = port_detections(cfg, model, ds, batch, device)
    net = copy.deepcopy(model).to("cpu", torch.float32).eval()
    rows = []
    unmatched = {"jax_only": 0, "torch_only": 0}
    for i in range(len(ds)):
        sample = ds[i]
        name = _name(sample["path"])
        K = sample["calib"].reshape(3, 3)
        image = np.ascontiguousarray(sample["image"].astype(np.float32).transpose(2, 0, 1)[None])
        with torch.no_grad():
            logits = net(torch.from_numpy(image))
        dec = reference_decode(tuple(np.ascontiguousarray(t.numpy()) for t in logits), thresh, topk, down)[0]
        pdet = port[name]
        valid = np.asarray(pdet["valid"]).astype(bool)
        pkeys = {}
        for k in np.nonzero(valid)[0]:
            cell = tuple(np.floor(pdet["m_proj"][k] / down).astype(int))
            pkeys[(int(pdet["cls"][k]), cell)] = int(k)
        seen = set()
        for t in range(len(dec["cls"])):
            key = (int(dec["cls"][t]), tuple(np.floor(dec["centers"][t] / down).astype(int)))
            if key not in pkeys:
                unmatched["torch_only"] += 1
                continue
            seen.add(key)
            k = pkeys[key]
            sol = reference_solve(int(dec["cls"][t]), dec["verts"][t], K, cfg.DETECTOR.dim_ref, cfg.DETECTOR.REF_LOC)
            cost_lm, cost_sp = float(pdet["cost"][k]), float(sol["cost"])
            rows.append({
                "img": name, "cls": int(dec["cls"][t]),
                "score_j": float(pdet["scores"][k]), "score_t": float(dec["scores"][t]),
                "dvert": float(np.abs(pdet["v_proj"][k] - dec["verts"][t]).max()),
                "cost_lm": cost_lm, "cost_scipy": cost_sp,
                "acc_j": bool(cost_lm < res_thresh), "acc_t": bool(cost_sp < res_thresh),
                "v_proj": pdet["v_proj"][k].tolist(), "K": K.tolist(),
            })
        unmatched["jax_only"] += int(valid.sum()) - len(seen)
    return {"summary": summarize(rows, unmatched), "rows": rows}


def summarize(rows: list, unmatched: dict) -> dict:
    flips = [r for r in rows if r["acc_j"] != r["acc_t"]]
    dcost = np.array([r["cost_lm"] - r["cost_scipy"] for r in rows])
    return {
        "n_matched": len(rows),
        "unmatched": unmatched,
        "max_dscore": max((abs(r["score_j"] - r["score_t"]) for r in rows), default=None),
        "max_dvert_px": max((r["dvert"] for r in rows), default=None),
        "cost_lm_minus_scipy_pct": {str(q): float(np.percentile(dcost, q)) for q in (0, 25, 50, 75, 90, 99, 100)}
        if rows else None,
        "gate_flips": len(flips),
        "flips_lm_rejected_scipy_accepted": sum(not r["acc_j"] for r in flips),
        "flips_scipy_rejected_lm_accepted": sum(not r["acc_t"] for r in flips),
        "accepted_jax": sum(r["acc_j"] for r in rows),
        "accepted_torch": sum(r["acc_t"] for r in rows),
    }


def run(work_dir: str, input_size: int = 512, batch: int = 8, eval_split: str = "train",
        backbone: str = "RESNET-18", bf16: bool = False, out: str | None = None, device=None,
        say=print) -> dict:
    device = resolve_device(device)
    cfg, model, ds = load_work_dir(work_dir, input_size, batch, eval_split, backbone, bf16)
    lm_solver.lm_solve.launches = 0
    t0 = time.perf_counter()
    report = diagnose(cfg, model, ds, batch, device)
    report["config"] = {"work_dir": work_dir, "input": list(cfg.INPUT_SIZE), "batch": batch,
                        "eval_split": eval_split, "backbone": backbone, "bf16": bf16, "device": str(device),
                        "card": _card(device), "seconds": time.perf_counter() - t0,
                        "lm_launches": lm_solver.lm_solve.launches, "frames": len(ds)}
    say(json.dumps(report["summary"], indent=1))
    flips = [r for r in report["rows"] if r["acc_j"] != r["acc_t"]]
    for r in sorted(flips, key=lambda r: -abs(r["cost_lm"] - r["cost_scipy"]))[:12]:
        say(f"flip {r['img']} cls{r['cls']} score {r['score_j']:.3f} cost LM {r['cost_lm']:.4f} "
            f"scipy {r['cost_scipy']:.4f} dvert {r['dvert']:.3f}px")
    if out:
        with open(out, "w") as f:
            json.dump(report, f, indent=1)
    return report


def main(argv=None):
    p = argparse.ArgumentParser("diag_same_weights")
    p.add_argument("--work-dir", required=True)
    p.add_argument("--input-size", type=int, default=512)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--eval-split", default="train")
    p.add_argument("--backbone", default="RESNET-18", choices=BACKBONES)
    p.add_argument("--bf16", action="store_true", help="serve the port leg in bf16 compute (a --bf16 campaign)")
    p.add_argument("--out", default=None)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    return run(args.work_dir, args.input_size, args.batch, args.eval_split, args.backbone, args.bf16, args.out,
               None if args.device == "cuda" else args.device)


if __name__ == "__main__":
    main()
