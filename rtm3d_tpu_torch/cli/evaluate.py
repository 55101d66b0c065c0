"""Evaluation entry point: detect over a split, then KITTI AP.

Port of ``rtm3d_tpu/cli/evaluate.py:21-125`` without int8: ``cli/detect.py``
writes one result file per image, then ``eval/ap.py`` scores them against
``training/label_2`` for each class x {bbox with AOS, bev, 3d} x {easy,
moderate, hard}, and the table is printed as JSON and returned.

    python -m rtm3d_tpu_torch.cli.evaluate --model-config CFG [--data-path P]
        [--split test] [--checkpoint CKPT] [--out-dir results] [--batch-size N]
        [--skip-detect] [--recall-points 11|40] [--set KEY VALUE ...] [--device cpu]

``--skip-detect`` scores the result files already in ``--out-dir``.
``--int8`` and ``--int8-guard`` raise ``NotImplementedError`` (int8 serving
is ROADMAP.md queue A: int8 PTQ).
"""

from __future__ import annotations

import argparse
import json
import os

from rtm3d_tpu_torch.cli import detect as detect_cli
from rtm3d_tpu_torch.config import load_config
from rtm3d_tpu_torch.eval.ap import evaluate_directories


def parse_args(argv=None):
    p = argparse.ArgumentParser("rtm3d_tpu_torch evaluate")
    p.add_argument("--model-config", type=str, required=True)
    p.add_argument("--data-path", type=str, default=None)
    p.add_argument("--split", type=str, default="test")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--out-dir", type=str, default="./results")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--device", type=str, default="cuda", help="the detect run's device: cuda (default) or cpu")
    p.add_argument("--int8", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--int8-guard", type=float, default=None, help=argparse.SUPPRESS)
    p.add_argument("--skip-detect", action="store_true")
    p.add_argument(
        "--recall-points", type=int, default=40, choices=(11, 40),
        help="AP recall grid: 40 = official devkit since 2019-10; 11 = "
        "legacy grid the upstream RTM3D paper's val tables use",
    )
    p.add_argument("--set", nargs="*", default=[])
    return p.parse_args(argv)


def _run_detect(args, data_path, out_dir):
    det_args = [
        "--model-config", args.model_config,
        "--data-path", data_path,
        "--split", args.split,
        "--out-dir", out_dir,
        "--batch-size", str(args.batch_size),
        "--device", args.device,
    ]
    if args.checkpoint:
        det_args += ["--checkpoint", args.checkpoint]
    if args.set:
        det_args += ["--set"] + list(args.set)
    return detect_cli.main(det_args)


def score(cfg, gt_dir, out_dir, names, recall_points=40, impl="cpp"):
    """The AP table, in percent rounded to 2 places: ``<cls>_{bbox, aos,
    bev, 3d}_{easy, moderate, hard}``. ``impl`` is the BEV overlap's route
    (``eval/ap.py``)."""
    results = {}
    for cls in cfg.DATASET.OBJs:
        for metric in ("bbox", "bev", "3d"):
            for diff in ("easy", "moderate", "hard"):
                if metric == "bbox":
                    # AOS rides the bbox matching (official devkit pairing)
                    ap, aos = evaluate_directories(
                        gt_dir, out_dir, names,
                        class_name=cls, metric=metric, difficulty=diff,
                        with_aos=True, recall_points=recall_points, impl=impl,
                    )
                    results[f"{cls}_aos_{diff}"] = round(100 * aos, 2)
                else:
                    ap = evaluate_directories(
                        gt_dir, out_dir, names,
                        class_name=cls, metric=metric, difficulty=diff,
                        recall_points=recall_points, impl=impl,
                    )
                results[f"{cls}_{metric}_{diff}"] = round(100 * ap, 2)
    return results


def main(argv=None):
    args = parse_args(argv)
    if args.int8 or args.int8_guard is not None:
        raise NotImplementedError("--int8/--int8-guard: int8 serving is not ported yet (ROADMAP.md, queue A: int8 PTQ)")
    cfg = load_config(args.model_config, args.set)
    data_path = args.data_path or cfg.DATASET.PATH

    if not args.skip_detect:
        _run_detect(args, data_path, args.out_dir)

    with open(os.path.join(data_path, "ImageSets", f"{args.split}.txt")) as f:
        names = sorted(f.read().splitlines())
    gt_dir = os.path.join(data_path, "training", "label_2")

    results = score(cfg, gt_dir, args.out_dir, names, args.recall_points)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
