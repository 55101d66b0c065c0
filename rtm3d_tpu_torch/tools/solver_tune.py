"""3D-solver variants against the reference's scipy costs of a diag dump.

Port of ``tools/solver_tune.py`` (:24-122). It reads a
``diag_same_weights --out`` file, whose rows hold each matched
candidate's scipy cost and the vertices and K the port's LM solved, and
solves those candidates again under the JAX tool's seven variants
(:101-109). (The JAX diag rows hold no vertices, so the JAX tool decodes
the eval split again and aligns its candidates to the rows by frame,
class and score; the port solves the rows' own vertices.) The JAX
``pallas`` rows are the LM kernel (``ops/lm_solver.py::lm_solve``, on the
card; on the CPU its plain version stands in), the ``jnp`` rows the plain
version (``lm_solve_reference``) called explicitly. Per variant: the
largest and the 90th percentile of LM minus scipy cost, the residual-gate
flips each way and the candidates where the LM is worse than scipy above
the gate, the accepted, the LM's launches and seconds. The deployed row
(40 iterations, prior 20, the detect step's own solve) is also held
against the diag rows' ``cost_lm``: ``deployed_vs_diag_max_abs``.

    python -m rtm3d_tpu_torch.tools.solver_tune --diag diag.json [--out solver_tune.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from rtm3d_tpu_torch.decode.solve3d import solve_bbox3d
from rtm3d_tpu_torch.ops import lm_solver
from rtm3d_tpu_torch.tools.ap_parity import _card, make_config
from rtm3d_tpu_torch.train.step import resolve_device

# (name, iterations, prior weight, the kernel (True) or its plain version)
VARIANTS = (
    ("kernel it40 prior20 (deployed)", 40, 20.0, True),
    ("kernel it40 prior0", 40, 0.0, True),
    ("kernel it100 prior0", 100, 0.0, True),
    ("kernel it200 prior0", 200, 0.0, True),
    ("plain it40 prior0", 40, 0.0, False),
    ("plain it200 prior0", 200, 0.0, False),
    ("kernel it100 prior20", 100, 20.0, True),
)


def tune(rows: list, device) -> dict:
    """The variants over the diag ``rows``."""
    cfg = make_config("", 512, 8, 1e-3)  # the serving priors and gate
    out = {"matched": len(rows), "variants": {}}
    if not rows:
        return out
    V = torch.tensor([r["v_proj"] for r in rows], dtype=torch.float32, device=device)
    K = torch.tensor([r["K"] for r in rows], dtype=torch.float32, device=device)
    C = torch.tensor([r["cls"] for r in rows], dtype=torch.int32, device=device)
    sp = np.array([r["cost_scipy"] for r in rows])
    diag_lm = np.array([r["cost_lm"] for r in rows])
    thr = float(cfg.DETECTOR.RESIDUAL_THRESH)
    for name, iters, prior, kernel in VARIANTS:
        lm_solver.lm_solve.launches = 0
        t0 = time.perf_counter()
        sol = solve_bbox3d(V, C, K, cfg.DETECTOR.dim_ref, cfg.DETECTOR.REF_LOC, iters=iters, prior_weight=prior,
                           solver=None if kernel else lm_solver.lm_solve_reference)
        lm = sol["cost"].cpu().numpy().astype(np.float64)
        d = lm - sp
        rec = {"iters": iters, "prior_weight": prior, "solver": "kernel" if kernel else "plain",
               "max_lm_minus_scipy": float(d.max()), "p90_lm_minus_scipy": float(np.percentile(d, 90)),
               "lm_rejects_scipy_accepts": int(((lm >= thr) & (sp < thr)).sum()),
               "lm_accepts_scipy_rejects": int(((lm < thr) & (sp >= thr)).sum()),
               "worse_above_gate": int(((lm > sp + 1e-6) & (lm >= thr)).sum()),
               "accepted": int((lm < thr).sum()), "seconds": time.perf_counter() - t0,
               "lm_launches": lm_solver.lm_solve.launches}
        if name.endswith("(deployed)"):
            rec["deployed_vs_diag_max_abs"] = float(np.abs(lm - diag_lm).max())
        out["variants"][name] = rec
    return out


def run(diag: str, out: str | None = None, device=None, say=print) -> dict:
    device = resolve_device(device)
    with open(diag) as f:
        rows = json.load(f)["rows"]
    report = tune(rows, device)
    report["config"] = {"diag": diag, "device": str(device), "card": _card(device)}
    say(f"candidates: {report['matched']} of the diag file")
    for name, r in report["variants"].items():
        say(f"{name}: max(lm-scipy) {r['max_lm_minus_scipy']:.4f} p90 {r['p90_lm_minus_scipy']:.4f} "
            f"lm-rejects-scipy-accepts {r['lm_rejects_scipy_accepts']} lm-accepts-scipy-rejects "
            f"{r['lm_accepts_scipy_rejects']} worse-above-gate {r['worse_above_gate']}")
    if out:
        with open(out, "w") as f:
            json.dump(report, f, indent=1)
    return report


def main(argv=None):
    p = argparse.ArgumentParser("solver_tune")
    p.add_argument("--diag", required=True, help="a diag_same_weights --out file")
    p.add_argument("--out", default=None)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    return run(args.diag, args.out, None if args.device == "cuda" else args.device)


if __name__ == "__main__":
    main()
