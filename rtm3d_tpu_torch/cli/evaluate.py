"""Evaluation entry point: detect over a split, then KITTI AP.

Port of ``rtm3d_tpu/cli/evaluate.py:21-125``: ``cli/detect.py`` writes one
result file per image, then ``eval/ap.py`` scores them against
``training/label_2`` for each class x {bbox with AOS, bev, 3d} x {easy,
moderate, hard}, and the table is printed as JSON and returned.

    python -m rtm3d_tpu_torch.cli.evaluate --model-config CFG [--data-path P]
        [--split test] [--checkpoint CKPT] [--out-dir results] [--batch-size N]
        [--int8 [--int8-guard MAX_DAP]] [--skip-detect] [--recall-points 11|40]
        [--set KEY VALUE ...] [--device cpu]

``--skip-detect`` scores the result files already in ``--out-dir``.
``--int8`` detects with ``--int8 --int8-3d-anyway --int8-no-gate`` (the AP
table is the gate here). ``--int8-guard MAX_DAP`` also detects and scores
the float path (into ``<out-dir>_fp``), prints the per-key int8 - float
deltas, and returns ``{"int8", "float", "delta"}``; when a moderate AP drops
by more than MAX_DAP points it prints a WARNING and exits with code 3
(``Int8GuardTripped``, which carries the three tables), as the JAX CLI does.
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
    p.add_argument("--int8", action="store_true", help="evaluate the int8 serving path (detect --int8)")
    p.add_argument(
        "--int8-guard", type=float, default=None, metavar="MAX_DAP",
        help="with --int8: also run the float path, print per-key AP deltas, and exit with code 3 if a "
        "moderate-difficulty AP drops by more than MAX_DAP points",
    )
    p.add_argument("--skip-detect", action="store_true")
    p.add_argument(
        "--recall-points", type=int, default=40, choices=(11, 40),
        help="AP recall grid: 40 = official devkit since 2019-10; 11 = "
        "legacy grid the upstream RTM3D paper's val tables use",
    )
    p.add_argument("--set", nargs="*", default=[])
    return p.parse_args(argv)


class Int8GuardTripped(SystemExit):
    """Exit code 3: int8 drops a moderate AP by more than ``--int8-guard``;
    ``results`` holds the int8, float and delta tables."""

    def __init__(self, results: dict):
        super().__init__(3)
        self.results = results


def _run_detect(args, data_path, out_dir, int8: bool = False):
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
    if int8:
        # the AP table measures int8's 3D accuracy, so 3D is on, and the
        # calibration-batch gate is skipped: the table is the stronger gate
        det_args += ["--int8", "--int8-3d-anyway", "--int8-no-gate"]
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
    cfg = load_config(args.model_config, args.set)
    data_path = args.data_path or cfg.DATASET.PATH

    if not args.skip_detect:
        _run_detect(args, data_path, args.out_dir, args.int8)

    with open(os.path.join(data_path, "ImageSets", f"{args.split}.txt")) as f:
        names = sorted(f.read().splitlines())
    gt_dir = os.path.join(data_path, "training", "label_2")

    results = score(cfg, gt_dir, args.out_dir, names, args.recall_points)
    if args.int8 and args.int8_guard is not None:
        # the accuracy gate: the float path on the same split, scored alike
        fp_dir = args.out_dir.rstrip("/\\") + "_fp"
        _run_detect(args, data_path, fp_dir, int8=False)
        fp_results = score(cfg, gt_dir, fp_dir, names, args.recall_points)
        deltas = {k: round(results[k] - fp_results[k], 2) for k in results}
        print("int8 - float AP deltas:", json.dumps(deltas, indent=2))
        results = {"int8": results, "float": fp_results, "delta": deltas}
        worst = min((v for k, v in deltas.items() if k.endswith("_moderate")), default=0.0)
        if worst < -args.int8_guard:
            print(f"WARNING: int8 drops moderate AP by {-worst:.2f} points (> {args.int8_guard}); "
                  "serve the float path instead")
            raise Int8GuardTripped(results)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
