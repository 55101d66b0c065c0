"""The AP evaluator's seconds at KITTI val scale, with the host C++ BEV
overlap and with its plain version, on the same files.

    python -m rtm3d_tpu_torch.eval.timing [--frames 3769] [--dets 100]
        [--root chip_smoke_out/eval_val] [--out FILE]

It writes ``--frames`` label files (KITTI's val split has 3,769) with
``data/synthetic.py``'s label writer at KITTI's 375x1242 frames, no images,
and for each frame a result file of ``--dets`` lines (a top-100 detector's
file): each label of the three classes, perturbed, then random boxes of
the three classes, scores uniform. It scores the 36-key table
(``cli/evaluate.py::score``) with ``impl="cpp"`` and with ``impl="plain"``
and prints one JSON line: each route's seconds, the seconds inside the
overlap alone, and whether the two tables are equal. The library is built
before the clock starts.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time

import numpy as np

from rtm3d_tpu_torch.cli.evaluate import score
from rtm3d_tpu_torch.config import default_config
from rtm3d_tpu_torch.data.synthetic import _DIMS, generate_kitti
from rtm3d_tpu_torch.eval import ap
from rtm3d_tpu_torch.eval.kitti_writer import alpha_from_ry, write_results

KITTI_HW = (375, 1242)


def write_results_tree(label_dir: str, out_dir: str, names, classes, dets: int, seed: int) -> int:
    """``dets`` result lines per frame: its labels of ``classes`` with noise
    on box, dims, location and yaw (scores 0.3-1), then random boxes (scores
    0-0.6). Returns the lines written."""
    rng = np.random.RandomState(seed)
    H, W = KITTI_HW
    total = 0
    for name in names:
        with open(os.path.join(label_dir, f"{name}.txt")) as f:
            rows = [l.split() for l in f.read().splitlines() if l]
        lines = []
        for p in rows:
            if p[0] not in classes:
                continue
            v = np.array(p[4:15], np.float64)  # x1 y1 x2 y2 h w l x y z ry
            v[0:4] += rng.randn(4) * 3.0
            v[4:7] *= 1.0 + rng.randn(3) * 0.05
            v[7:10] += rng.randn(3) * np.array([0.3, 0.1, 0.8])
            v[10] += rng.randn() * 0.2
            lines.append((p[0], v, rng.uniform(0.3, 1.0)))
        while len(lines) < dets:
            cls = classes[rng.randint(len(classes))]
            h, w, l = np.array(_DIMS[cls]) * rng.uniform(0.9, 1.1, 3)
            z = rng.uniform(5, 60)
            x1, y1 = rng.uniform(0, W - 160), rng.uniform(100, H - 130)
            bw, bh = rng.uniform(20, 150), rng.uniform(20, 120)
            v = np.array([x1, y1, x1 + bw, y1 + bh, h, w, l, rng.uniform(-0.35, 0.35) * z, 1.65, z,
                          rng.uniform(-np.pi, np.pi)])
            lines.append((cls, v, rng.uniform(0.0, 0.6)))
        out = [f"{c} 0.00 0 {alpha_from_ry(v[10], v[7], v[9]):.2f} " + " ".join(f"{t:.2f}" for t in v)
               + f" {s:.4f}" for c, v, s in lines[:dets]]
        write_results(out_dir, name, out)
        total += len(out)
    return total


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("rtm3d_tpu_torch AP evaluator timing")
    p.add_argument("--frames", type=int, default=3769, help="label files (KITTI val: 3,769)")
    p.add_argument("--dets", type=int, default=100, help="result lines per frame")
    p.add_argument("--root", default=os.path.join("chip_smoke_out", "eval_val"))
    p.add_argument("--seed", type=int, default=20)
    p.add_argument("--out", default=None, help="also write the JSON record here")
    a = p.parse_args(argv)

    shutil.rmtree(a.root, ignore_errors=True)
    t0 = time.perf_counter()
    generate_kitti(a.root, 0, a.frames, KITTI_HW, max_objs=8, seed=a.seed, images=False)
    with open(os.path.join(a.root, "ImageSets", "test.txt")) as f:
        names = f.read().split()
    classes = list(default_config().DATASET.OBJs)
    label_dir = os.path.join(a.root, "training", "label_2")
    det_dir = os.path.join(a.root, "results")
    lines = write_results_tree(label_dir, det_dir, names, classes, a.dets, a.seed)
    setup_s = time.perf_counter() - t0
    ap._geometry()  # the library's build stays out of the clock

    cfg = default_config()
    rec = {"frames": a.frames, "dets_per_frame": a.dets, "result_lines": lines, "setup_s": setup_s,
           "label_lines": sum(1 for n in names for l in open(os.path.join(label_dir, f"{n}.txt")) if l.strip())}
    tables = {}
    plain_overlap = ap.bev_intersection_matrix
    for impl in ("cpp", "plain"):
        spent = [0.0, 0]

        def timed_overlap(x, y, route="cpp"):
            t = time.perf_counter()
            out = plain_overlap(x, y, route)
            spent[0] += time.perf_counter() - t
            spent[1] += out.size
            return out

        ap.bev_intersection_matrix = timed_overlap
        try:
            t = time.perf_counter()
            tables[impl] = score(cfg, label_dir, det_dir, names, impl=impl)
            rec[f"{impl}_s"] = time.perf_counter() - t
        finally:
            ap.bev_intersection_matrix = plain_overlap
        rec[f"{impl}_overlap_s"], rec["overlaps"] = spent
    rec["tables_equal"] = tables["cpp"] == tables["plain"]
    rec["table_cpp"] = tables["cpp"]
    print(json.dumps(rec), flush=True)
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(rec, f, indent=1)
    shutil.rmtree(a.root, ignore_errors=True)
    return rec


if __name__ == "__main__":
    main()
