"""KITTI-format detection writer.

The port's copy of ``rtm3d_tpu/eval/kitti_writer.py:18-63``, line for line.
The reference has no result writer (SURVEY.md §6); this writes the KITTI
object-detection submission format, which any KITTI devkit and
``eval/ap.py`` score:

  type trunc occ alpha x1 y1 x2 y2 h w l x y z ry score
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np


def alpha_from_ry(ry: float, x: float, z: float) -> float:
    """Observation angle from global yaw + viewing ray."""
    a = ry - np.arctan2(x, z)
    return float((a + np.pi) % (2 * np.pi) - np.pi)


def detections_to_lines(det: Dict[str, np.ndarray], class_names: Sequence[str], img_index: int):
    """Format one image's accepted detections (fixed arrays + masks) as KITTI
    lines. det fields: cls, scores, accepted, bbox2d, ry, dim, loc — already
    sliced to a single image (K, ...).

    2D-only detections (no ry/dim/loc fields, e.g. the int8 serving default)
    are written with the KITTI 2D-submission placeholders: dims -1, location
    -1000, ry/alpha -10 — the convention KITTI's devkit treats as
    "3D fields not evaluated"."""
    lines = []
    acc = np.asarray(det["accepted"][img_index])
    has_3d = "dim" in det and "loc" in det and "ry" in det
    for i in np.where(acc)[0]:
        c = int(det["cls"][img_index][i])
        name = class_names[c]
        x1, y1, x2, y2 = (float(v) for v in det["bbox2d"][img_index][i])
        score = float(det["scores"][img_index][i])
        if has_3d:
            h, w, l = (float(v) for v in det["dim"][img_index][i])
            x, y, z = (float(v) for v in det["loc"][img_index][i])
            # the 3D solver parameterises Y at the box center (solve3d.py);
            # KITTI location is the bottom-face center
            y = y + h / 2
            ry = float(det["ry"][img_index][i])
            alpha = alpha_from_ry(ry, x, z)
        else:
            h = w = l = -1.0
            x = y = z = -1000.0
            ry = alpha = -10.0
        lines.append(
            f"{name} 0.00 0 {alpha:.2f} {x1:.2f} {y1:.2f} {x2:.2f} {y2:.2f} "
            f"{h:.2f} {w:.2f} {l:.2f} {x:.2f} {y:.2f} {z:.2f} {ry:.2f} {score:.4f}"
        )
    return lines


def write_results(out_dir: str, image_name: str, lines):
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{image_name}.txt"), "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))
