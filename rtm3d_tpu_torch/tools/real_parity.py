"""The one-command real-data protocol of the north star, on the port.

Port of ``tools/real_parity.py``. The north star is AP3D within 0.1 of
the reference's pretrained checkpoint on KITTI; neither KITTI nor the
reference's ``model_best.pt`` is in the repository. This is the command
that runs the protocol the day both are on the card's machine:

    python -m rtm3d_tpu_torch.tools.real_parity --data-path /data/kitti --split val \\
        --torch-checkpoint /ckpts/model_best.pt --backbone DLA-34 --input-size 1280 \\
        --bootstrap 500 --out real_parity_report.json [--device cpu]

In the JAX tool's order:
  1. load the ``.pt`` into the port's model by longest-suffix matching
     (``train/checkpoint.py::import_reference_weights``, the reference
     CheckPointer's own rule); a partial import is refused unless
     ``--allow-partial-import``;
  2. serve the split through the port's pipeline (the loader, the batched
     decode and the LM kernel, on the card; fp32 with TF32 off) and
     through the reference pipeline (``tools/reference_pipeline.py``: the
     per-image decode and a scipy L-BFGS-B solve per detection, on the
     host), the same weights on the same pixels (normalised on the host,
     ``TPU.NORMALIZE_ON_DEVICE`` off, as the JAX tool feeds both stacks);
  3. with ``--int8``, an int8 leg: the port's pipeline on the quantized
     network (absmax scales over the split's first 2 batches, fp32 with
     TF32 off, ``TPU.INT8_SKIP``; ``QuantConv``'s kernels), with the 3D
     solve;
  4. one KITTI result file per frame and leg under ``--work-dir``;
  5. every (class x metric x difficulty) cell at the devkit bars (or
     ``--min-overlap``/``--min-height`` on a synthetic tree) on both recall
     grids, R40 and R11 (``eval/ap.py``);
  6. with ``--bootstrap N``, percentile-bootstrap 95% intervals over the
     split's frames of the port-minus-reference deltas (and int8 minus
     port), each leg re-scored on the same draws.

The report has the JAX tool's keys: ``config``, ``accepted_counts``,
``ap_r40`` and ``ap_r11`` (27 cells each) and ``bootstrap``; the JAX
tool's ``jax`` column is ``port`` here, ``torch`` is the reference
pipeline's, and ``delta`` is port minus reference: the same weights on
the same pixels, so a delta is the serving path's alone. Beside them,
each leg's seconds and the port leg's batches and LM launches.

Both legs write 2D boxes in the original frame's pixels, clipped to it,
as ``cli/detect.py`` writes them (``original_frame_boxes``); the JAX tool
writes both legs' boxes in the network's input frame, which on KITTI
(1242 px scaled to 1280) moves them against the ground truth: a perfect
detector's bbox AP falls to 0.36-1.79 at the devkit bars, its bev and 3D
cells unmoved (tests/test_torch_real_parity.py).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import tempfile
import time

import numpy as np
import torch

from rtm3d_tpu_torch.cli.detect import original_frame_boxes
from rtm3d_tpu_torch.config import default_config
from rtm3d_tpu_torch.data.kitti import create_dataset
from rtm3d_tpu_torch.data.loader import DataLoader
from rtm3d_tpu_torch.eval.ap import evaluate_ap, evaluate_directories, parse_kitti_line
from rtm3d_tpu_torch.eval.kitti_writer import detections_to_lines, write_results
from rtm3d_tpu_torch.nn.model import create_model
from rtm3d_tpu_torch.ops import lm_solver
from rtm3d_tpu_torch.tools.bench_latency import KFNS, int8_model
from rtm3d_tpu_torch.tools.reference_pipeline import reference_rows
from rtm3d_tpu_torch.train.checkpoint import import_reference_weights, load_torch_weights
from rtm3d_tpu_torch.train.step import make_detect_step, resolve_device

CLASSES = ("Car", "Pedestrian", "Cyclist")
METRICS = ("bbox", "bev", "3d")
DIFFICULTIES = ("easy", "moderate", "hard")


def make_config(data_path: str, input_size: int, backbone: str, score_thresh: float, topk: int):
    """The JAX tool's serving config: ``backbone`` at ``input_size`` under
    IS_RECT, fp32, host normalisation (both legs eat the same pixels), the
    reference's serving gates, MAX_OBJS 32 (KITTI scenes carry up to ~30
    labels)."""
    cfg = default_config()
    cfg.MODEL.BACKBONE = backbone
    cfg.MODEL.KFNs = KFNS[backbone]
    cfg.INPUT_SIZE = (input_size, input_size)
    cfg.IS_RECT = True
    cfg.DATASET.PATH = data_path
    cfg.DATASET.MAX_OBJS = 32
    cfg.DETECTOR.SCORE_THRESH = float(score_thresh)
    cfg.DETECTOR.TOPK_CANDIDATES = int(topk)
    cfg.TPU.NORMALIZE_ON_DEVICE = False
    return cfg


def _name(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def detect_port(cfg, model, ds, batch: int, out_dir: str, device) -> dict:
    """The port's pipeline over ``ds`` into ``out_dir``, as ``cli/detect.py``
    runs it: a padded final batch, the detect step (network, decode, the
    LM kernel's two launches), boxes to the original frame. Returns the
    batches and the LM's launches."""
    detect = make_detect_step(model, cfg, with_3d=True, device=device)
    loader = DataLoader(ds, min(batch, len(ds)), shuffle=False, drop_last=False, pad_final=True)
    names = list(cfg.DATASET.OBJs)
    lm_solver.lm_solve.launches = 0
    batches = 0
    for b in loader:
        det = detect(b["image"], b["calib"].reshape(-1, 3, 3).astype(np.float32))
        det = {k: v.cpu().numpy() for k, v in det.items()}
        batches += 1
        for bi in range(int(b["num_valid"])):
            det_i = {k: v[bi:bi + 1] for k, v in det.items()}
            det_i["bbox2d"] = original_frame_boxes(det["bbox2d"][bi], b["shape"][bi], ds.resize_max_side,
                                                   ds.img_size)[None]
            write_results(out_dir, _name(b["path"][bi]), detections_to_lines(det_i, names, 0))
    return {"batches": batches, "lm_launches": lm_solver.lm_solve.launches}


def detect_reference(cfg, model, ds, out_dir: str) -> None:
    """The reference pipeline over ``ds`` into ``out_dir``, frame by frame
    on the host, the model in fp32; boxes to the original frame."""
    net = copy.deepcopy(model).to("cpu", torch.float32).eval()
    names = list(cfg.DATASET.OBJs)
    for i in range(len(ds)):
        sample = ds[i]
        det = reference_rows(net, sample["image"].astype(np.float32), sample["calib"].reshape(3, 3), cfg)
        if det["cls"].shape[1]:
            det["bbox2d"] = original_frame_boxes(det["bbox2d"][0], sample["shape"], ds.resize_max_side,
                                                 ds.img_size)[None]
        write_results(out_dir, _name(sample["path"]), detections_to_lines(det, names, 0))


def int8_calib(ds, batch: int, device, calib_batches: int = 2) -> list:
    """The JAX tool's calibration frames (``_int8_apply``): the split's
    first ``calib_batches`` batches, on ``device``."""
    loader = DataLoader(ds, min(batch, len(ds)), shuffle=False, drop_last=False, pad_final=True)
    calib = []
    for b in loader:
        if len(calib) >= calib_batches:
            break
        calib.append(torch.from_numpy(b["image"].astype(np.float32)).to(device))
    return calib


def count_accepted(results_dir: str) -> int:
    n = 0
    for fn in os.listdir(results_dir):
        if fn.endswith(".txt"):
            with open(os.path.join(results_dir, fn)) as f:
                n += sum(1 for line in f if line.strip())
    return n


def _split_names(data: str, split: str) -> list:
    with open(os.path.join(data, "ImageSets", f"{split}.txt")) as f:
        return sorted(f.read().splitlines())


def score_legs(data: str, res: dict, min_overlap=None, min_height=None, split: str = "test",
               recall_points: int = 40) -> dict:
    """``_score_both`` of ``tools/ap_parity.py``: every (class, metric,
    difficulty) cell of each leg in ``res`` ({"port", "torch"[, "int8"][,
    "samew"]}: result dirs) in AP points, ``delta`` = port - torch,
    ``delta_int8`` = int8 - port and ``delta_samew`` = samew - torch."""
    names = _split_names(data, split)
    gt_dir = os.path.join(data, "training", "label_2")
    out = {}
    for cls in CLASSES:
        for metric in METRICS:
            for diff in DIFFICULTIES:
                kw = dict(class_name=cls, metric=metric, difficulty=diff, min_overlap=min_overlap,
                          min_height=min_height, recall_points=recall_points)
                ap = {leg: evaluate_directories(gt_dir, d, names, **kw) for leg, d in res.items()}
                cell = {"port": round(100 * ap["port"], 2), "torch": round(100 * ap["torch"], 2),
                        "delta": round(100 * (ap["port"] - ap["torch"]), 2)}
                if "int8" in ap:
                    cell["int8"] = round(100 * ap["int8"], 2)
                    cell["delta_int8"] = round(100 * (ap["int8"] - ap["port"]), 2)
                if "samew" in ap:
                    cell["samew"] = round(100 * ap["samew"], 2)
                    cell["delta_samew"] = round(100 * (ap["samew"] - ap["torch"]), 2)
                out[f"{cls}_{metric}_{diff}"] = cell
    return out


def _ci95(v) -> list:
    return [round(float(np.percentile(v, 2.5)), 2), round(float(np.percentile(v, 97.5)), 2)]


def bootstrap_cis(data: str, res: dict, n_resamples: int = 500, min_overlap=None, min_height=None, seed: int = 0,
                  split: str = "test") -> dict:
    """``bootstrap_cis`` of ``tools/ap_parity.py``: percentile-bootstrap 95%
    intervals over the split's frames of the port-minus-reference delta
    (``delta_ci95``), with an int8 leg int8 minus port
    (``delta_int8_ci95``) and with a samew leg samew minus reference
    (``delta_samew_ci95``), moderate difficulty, per class and metric;
    every leg re-scored on the same draws, so an interval is the split's
    own metric noise, the yardstick a point delta is judged by."""
    names = _split_names(data, split)
    gt_dir = os.path.join(data, "training", "label_2")

    def load(dir_, with_score):
        out = []
        for name in names:
            p = os.path.join(dir_, f"{name}.txt")
            if not os.path.exists(p):
                out.append([])
                continue
            with open(p) as f:
                out.append([parse_kitti_line(l, with_score) for l in f.read().splitlines() if l])
        return out

    gts = load(gt_dir, False)
    legs = {k: load(d, True) for k, d in res.items()}
    draws = np.random.RandomState(seed).randint(0, len(names), size=(n_resamples, len(names)))
    out = {"n_resamples": n_resamples, "n_images": len(names)}
    for cls in CLASSES:
        for metric in METRICS:
            d_pt, d_qp, d_sw = [], [], []
            for draw in draws:
                g = [gts[i] for i in draw]
                ap = {k: evaluate_ap(g, [det[i] for i in draw], class_name=cls, metric=metric,
                                     difficulty="moderate", min_overlap=min_overlap, min_height=min_height)
                      for k, det in legs.items()}
                d_pt.append(100.0 * (ap["port"] - ap["torch"]))
                if "int8" in ap:
                    d_qp.append(100.0 * (ap["int8"] - ap["port"]))
                if "samew" in ap:
                    d_sw.append(100.0 * (ap["samew"] - ap["torch"]))
            cell = {"delta_ci95": _ci95(d_pt)}
            if d_qp:
                cell["delta_int8_ci95"] = _ci95(d_qp)
            if d_sw:
                cell["delta_samew_ci95"] = _ci95(d_sw)
            out[f"{cls}_{metric}_moderate"] = cell
    return out


def run_real_parity(data_path: str, torch_checkpoint: str, split: str = "val", backbone: str = "DLA-34",
                    input_size: int = 1280, batch: int = 8, work_dir: str | None = None,
                    score_thresh: float = 0.4, topk: int = 100, bootstrap: int = 0, with_int8: bool = False,
                    allow_partial_import: bool = False, min_overlap: float | None = None,
                    min_height: float | None = None, device=None, progress=print) -> dict:
    device = resolve_device(device)
    work_dir = work_dir or os.path.join(tempfile.gettempdir(), "real_parity")
    os.makedirs(work_dir, exist_ok=True)
    cfg = make_config(data_path, input_size, backbone, score_thresh, topk)
    ds = create_dataset(data_path, cfg, is_training=False, split=split)
    cfg.INPUT_SIZE = tuple(ds.img_size)
    w, h = cfg.INPUT_SIZE
    progress(f"real-parity [{backbone}] on {data_path} split {split}: {len(ds)} images at {w}x{h}, {device}")

    # 1. the checkpoint into the port's model, by suffix
    model = create_model(cfg)
    sd, _ = load_torch_weights(torch_checkpoint)
    rep = import_reference_weights(model, sd)
    progress(f"imported {len(rep['loaded'])} tensors from {torch_checkpoint}; {len(rep['missed'])} missed")
    if rep["missed"] and not allow_partial_import:
        raise SystemExit(f"import missed {len(rep['missed'])} model tensors (first: {rep['missed'][:5]}); a "
                         "partial import invalidates the same-weights claim: pass --allow-partial-import to override")
    model.eval()

    # 2-4. the legs, into KITTI result dirs; the card's convs in fp32
    res = {"port": os.path.join(work_dir, "results_port"), "torch": os.path.join(work_dir, "results_torch")}
    legs = {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        legs["port"] = detect_port(cfg, model, ds, batch, res["port"], device)
        legs["port"]["seconds"] = time.perf_counter() - t0
        progress(f"port leg done: {legs['port']}")
        if with_int8:
            res["int8"] = os.path.join(work_dir, "results_int8")
            t0 = time.perf_counter()
            qmodel = int8_model(model, cfg, int8_calib(ds, batch, device), device)
            legs["int8"] = detect_port(cfg, qmodel, ds, batch, res["int8"], device)
            legs["int8"]["seconds"] = time.perf_counter() - t0
            progress(f"int8 leg done: {legs['int8']}")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    t0 = time.perf_counter()
    detect_reference(cfg, model, ds, res["torch"])
    legs["torch"] = {"seconds": time.perf_counter() - t0}
    progress(f"reference leg done: {legs['torch']}")
    counts = {leg: count_accepted(d) for leg, d in res.items()}
    progress(f"accepted detections: {counts}")

    # 5. devkit-bar AP on both recall grids
    out = {
        "config": {
            "data_path": data_path, "split": split, "backbone": backbone, "input": [w, h],
            "torch_checkpoint": torch_checkpoint, "score_thresh": cfg.DETECTOR.SCORE_THRESH,
            "topk": cfg.DETECTOR.TOPK_CANDIDATES, "residual_thresh": float(cfg.DETECTOR.RESIDUAL_THRESH),
            "min_overlap": min_overlap, "min_height": min_height, "n_images": len(ds), "device": str(device),
            "card": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        },
        "accepted_counts": counts,
        "legs": legs,
    }
    for rp in (40, 11):
        out[f"ap_r{rp}"] = score_legs(data_path, res, min_overlap=min_overlap, min_height=min_height, split=split,
                                      recall_points=rp)
    car3d = out["ap_r40"]["Car_3d_moderate"]
    progress(f"Car 3D moderate (R40): port {car3d['port']} reference {car3d['torch']} delta {car3d['delta']}")

    # 6. bootstrap intervals
    if bootstrap:
        out["bootstrap"] = bootstrap_cis(data_path, res, n_resamples=bootstrap, min_overlap=min_overlap,
                                         min_height=min_height, split=split)
    return out


def main(argv=None):
    p = argparse.ArgumentParser("real_parity")
    p.add_argument("--data-path", required=True,
                   help="KITTI root: training/{image_2,label_2,calib} + ImageSets/<split>.txt")
    p.add_argument("--torch-checkpoint", required=True, help="reference .pt/.pth checkpoint (e.g. model_best.pt)")
    p.add_argument("--split", default="val")
    p.add_argument("--backbone", default="DLA-34", choices=("DLA-34", "RESNET-18"))
    p.add_argument("--input-size", type=int, default=1280)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--work-dir", default=None, help="result dirs (default: real_parity under the temp directory)")
    p.add_argument("--score-thresh", type=float, default=0.4)
    p.add_argument("--topk", type=int, default=100)
    p.add_argument("--bootstrap", type=int, default=0)
    p.add_argument("--int8", action="store_true", help="also run the int8 serving leg")
    p.add_argument("--allow-partial-import", action="store_true")
    p.add_argument("--min-overlap", type=float, default=None,
                   help="override the devkit IoU bars (synthetic dry-runs only; leave unset for the real protocol)")
    p.add_argument("--min-height", type=float, default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu: the port's legs")
    args = p.parse_args(argv)
    out = run_real_parity(
        args.data_path, args.torch_checkpoint, split=args.split, backbone=args.backbone,
        input_size=args.input_size, batch=args.batch, work_dir=args.work_dir, score_thresh=args.score_thresh,
        topk=args.topk, bootstrap=args.bootstrap, with_int8=args.int8,
        allow_partial_import=args.allow_partial_import, min_overlap=args.min_overlap, min_height=args.min_height,
        device=None if args.device == "cuda" else args.device,
    )
    print(json.dumps(out, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
