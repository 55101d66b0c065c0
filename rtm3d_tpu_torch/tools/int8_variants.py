"""int8 serving variants on a trained production-parity checkpoint.

Port of ``tools/int8_variants.py`` (:36-153). Two axes:

- the skip POLICY, which convs stay float (``nn/quant.py::skip_scales``,
  the JAX tool's patterns on the JAX module paths the port's scales keep):
    full          every calibrated conv int8;
    float-head    the header's output convs (``/head``) float, the
                  serving default (``TPU.INT8_SKIP``);
    float-vertex  ``/head`` and the vertex branches (``VERTEX_BRANCHES``:
                  ``offset_fr_main``, ``main_offset``) float;
    float-header  the whole header float (backbone and KFPN int8);
- the CALIBRATION of the activation clips
  (``nn/quant.py::calibrate_act_scales``): absmax, p99.9, p99.99 or mse,
  with ``--calib-sweep`` each with and without per-input-channel clips on
  the vertex branches, under ``full`` and ``float-head``, then p99.9 and
  mse under ``float-vertex`` (per-channel x float-vertex is not swept: the
  policy makes float exactly the convs ``per_channel`` targets, :100-105).

Calibration: the train split's first ``--calib-batches`` batches of the
test transform, on the fp32 network with TF32 off. Each variant serves the
eval split through the port's pipeline with the 3D solve (fp32, TF32 off;
on the card the ``conv_s8`` and ``quantize`` kernels, once per int8 conv a
batch, and the LM kernel) into ``results_int8_<name>``, scored against
the float leg ``results_port``: accepted lines, their share of the float
leg's, the worst |delta AP| and the non-zero cells, the seconds and the
kernels' launches. The report goes to ``int8_variants.json`` in the work
dir.

    python -m rtm3d_tpu_torch.tools.int8_variants --work-dir DIR [--calib-sweep] [--calib-batches 2]
        [--input-size 512] [--batch 8] [--eval-split train] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time

from rtm3d_tpu_torch.data.kitti import create_dataset
from rtm3d_tpu_torch.nn import quant
from rtm3d_tpu_torch.ops import int8_conv
from rtm3d_tpu_torch.tools.ap_parity import BACKBONES, _card, int8_convs, tf32_mode
from rtm3d_tpu_torch.tools.bench_latency import act_scales
from rtm3d_tpu_torch.tools.diag_same_weights import load_work_dir
from rtm3d_tpu_torch.tools.real_parity import count_accepted, detect_port, int8_calib, score_legs
from rtm3d_tpu_torch.train.step import resolve_device

# the 3D residual gate reads v_proj = f(offset_fr_main, main_offset)
VERTEX_BRANCHES = ("detect_header/offset_fr_main/", "detect_header/main_offset/")
POLICIES = ("full", "float-head", "float-vertex", "float-header")


def policy_scales(scales: dict, policy: str) -> dict:
    if policy == "full":
        return scales
    if policy == "float-head":
        return quant.skip_scales(scales, ("/head",))
    if policy == "float-vertex":
        return quant.skip_scales(scales, ("/head",) + VERTEX_BRANCHES)
    if policy == "float-header":
        return quant.skip_scales(scales, ("detect_header/",))
    raise ValueError(policy)


def variants(calib_sweep: bool) -> list:
    """(method, per-channel vertex clips, policy) of each row, the JAX
    tool's list (:96-108)."""
    if not calib_sweep:
        return [("absmax", False, p) for p in POLICIES]
    out = [(m, pc, p) for m in ("absmax", "p99.9", "p99.99", "mse") for pc in (False, True)
           for p in ("full", "float-head")]
    return out + [("p99.9", False, "float-vertex"), ("mse", False, "float-vertex")]


def run(work_dir: str, input_size: int = 512, batch: int = 8, eval_split: str = "train", calib_sweep: bool = False,
        calib_batches: int = 2, backbone: str = "RESNET-18", device=None, say=print) -> dict:
    device = resolve_device(device)
    cfg, model, eval_ds = load_work_dir(work_dir, input_size, batch, eval_split, backbone)
    train_ds = create_dataset(cfg.DATASET.PATH, cfg, is_training=False, split="train")
    train_ds.img_size = list(cfg.INPUT_SIZE)
    calib = int8_calib(train_ds, batch, device, calib_batches)
    res_float = os.path.join(work_dir, "results_port")
    n_float = count_accepted(res_float)
    report = {"float_accepted": n_float, "eval_split": eval_split, "calib_batches": calib_batches,
              "card": _card(device)}
    scale_cache = {}
    for method, pc, policy in variants(calib_sweep):
        if (method, pc) not in scale_cache:
            scale_cache[(method, pc)] = act_scales(model, calib, device, method, VERTEX_BRANCHES if pc else ())
        name = f"{method}{'_pc' if pc else ''}_{policy}"
        out = os.path.join(work_dir, f"results_int8_{name}")
        qmodel = quant.quantize_model(model, policy_scales(scale_cache[(method, pc)], policy))
        int8_conv.conv_s8.launches = int8_conv.quantize.launches = 0
        t0 = time.perf_counter()
        with tf32_mode(False):
            leg = detect_port(cfg, qmodel, eval_ds, batch, out, device)
        n = count_accepted(out)
        aps = score_legs(cfg.DATASET.PATH, {"port": res_float, "torch": out}, split=eval_split)
        cells = {k: {"port": v["port"], "int8": v["torch"], "delta_int8": round(v["torch"] - v["port"], 2)}
                 for k, v in aps.items() if v["port"] or v["torch"]}
        worst = max((abs(v["delta_int8"]) for v in cells.values()), default=0.0)
        say(f"{name}: accepted {n}/{n_float}, worst |dAP| vs float {worst}")
        report[name] = {
            "method": method, "per_channel_vertex": pc, "policy": policy, "accepted": n,
            "accepted_frac": round(n / max(n_float, 1), 3), "worst_abs_dap": worst, "ap": cells,
            "seconds": time.perf_counter() - t0, "batches": leg["batches"], "int8_convs": int8_convs(qmodel),
            "launches": {"conv_s8": int8_conv.conv_s8.launches, "quantize": int8_conv.quantize.launches,
                         "lm": leg["lm_launches"]},
        }
    with open(os.path.join(work_dir, "int8_variants.json"), "w") as f:
        json.dump(report, f, indent=1)
    say(f"float leg accepted: {n_float}")
    return report


def main(argv=None):
    p = argparse.ArgumentParser("int8_variants")
    p.add_argument("--work-dir", required=True)
    p.add_argument("--input-size", type=int, default=512)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--eval-split", default="train")
    p.add_argument("--calib-sweep", action="store_true",
                   help="sweep the calibrations (absmax/p99.9/p99.99/mse, each with and without per-channel "
                   "vertex-branch clips) x {full, float-head} instead of the absmax policy sweep")
    p.add_argument("--calib-batches", type=int, default=2)
    p.add_argument("--backbone", default="RESNET-18", choices=BACKBONES)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    return run(args.work_dir, args.input_size, args.batch, args.eval_split, args.calib_sweep, args.calib_batches,
               args.backbone, None if args.device == "cuda" else args.device)


if __name__ == "__main__":
    main()
