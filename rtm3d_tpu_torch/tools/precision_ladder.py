"""Same-weights AP at each forward precision of the port's serving path.

Port of ``tools/precision_ladder.py`` (:32-89). The JAX tool's rungs are
the TPU's matmul precisions; on the card they become:

  fp32  TF32 off in cuDNN and cuBLAS: true fp32 convolutions, the JAX
        ``highest`` (6-pass bf16) rung, which isolates the pipelines'
        divergence; the serving legs of ``ap_parity`` run this;
  tf32  cuDNN's and cuBLAS's TF32 on (PyTorch's default for convolutions),
        for the JAX ``default``: the TPU's single bf16 pass, a reduced
        mantissa in the products;
  bf16  ``TPU.COMPUTE_DTYPE`` bfloat16: the deployed mixed-precision
        serving, the network's parameters and BN statistics cast.

Each rung re-runs the port's leg of a production work dir into
``results_port_<rung>`` and is scored against the unchanged reference leg
(``results_torch``); the report (``precision_ladder.json`` in the work
dir) has, per rung, the accepted lines, the worst |delta AP| against the
reference, the cells where either side is non-zero, the seconds, the LM's
launches and, with ``--bootstrap``, the intervals.

    python -m rtm3d_tpu_torch.tools.precision_ladder --work-dir DIR [--input-size 512] [--batch 8]
        [--eval-split train] [--bootstrap N] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time

from rtm3d_tpu_torch.tools.ap_parity import _card, tf32_mode
from rtm3d_tpu_torch.tools.diag_same_weights import load_work_dir
from rtm3d_tpu_torch.tools.real_parity import bootstrap_cis, count_accepted, detect_port, score_legs
from rtm3d_tpu_torch.train.step import resolve_device

RUNGS = {"fp32": ("float32", False), "tf32": ("float32", True), "bf16": ("bfloat16", False)}


def run(work_dir: str, input_size: int = 512, batch: int = 8, eval_split: str = "train", bootstrap: int = 0,
        device=None, say=print) -> dict:
    device = resolve_device(device)
    cfg, model, ds = load_work_dir(work_dir, input_size, batch, eval_split)
    data = cfg.DATASET.PATH
    res_t = os.path.join(work_dir, "results_torch")
    if not os.path.isdir(res_t):
        raise FileNotFoundError(f"{res_t}: run ap_parity --production on {work_dir} first")
    n_ref = count_accepted(res_t)
    report = {"eval_split": eval_split, "torch_accepted": n_ref, "card": _card(device)}
    for rung, (dtype, tf32) in RUNGS.items():
        out = os.path.join(work_dir, f"results_port_{rung}")
        rcfg = cfg.clone()
        rcfg.TPU.COMPUTE_DTYPE = dtype
        t0 = time.perf_counter()
        with tf32_mode(tf32):
            leg = detect_port(rcfg, model, ds, batch, out, device)
        n = count_accepted(out)
        aps = score_legs(data, {"port": out, "torch": res_t}, split=eval_split)
        cells = {k: v for k, v in aps.items() if v["port"] > 0 or v["torch"] > 0}
        worst = max((abs(v["delta"]) for v in cells.values()), default=0.0)
        row = {"compute_dtype": dtype, "tf32": tf32, "accepted": n, "worst_abs_dap_vs_torch": worst, "ap": cells,
               "seconds": time.perf_counter() - t0, "batches": leg["batches"], "lm_launches": leg["lm_launches"]}
        if bootstrap:
            row["bootstrap"] = bootstrap_cis(data, {"port": out, "torch": res_t}, n_resamples=bootstrap,
                                             split=eval_split)
        say(f"{rung}: accepted {n} (torch {n_ref}), worst |dAP| vs torch {worst}")
        report[rung] = row
    with open(os.path.join(work_dir, "precision_ladder.json"), "w") as f:
        json.dump(report, f, indent=1)
    return report


def main(argv=None):
    p = argparse.ArgumentParser("precision_ladder")
    p.add_argument("--work-dir", required=True)
    p.add_argument("--input-size", type=int, default=512)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--eval-split", default="train")
    p.add_argument("--bootstrap", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    return run(args.work_dir, args.input_size, args.batch, args.eval_split, args.bootstrap,
               None if args.device == "cuda" else args.device)


if __name__ == "__main__":
    main()
