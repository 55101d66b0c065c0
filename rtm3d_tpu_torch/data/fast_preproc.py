"""The label half of the JAX package's fused preprocessing.

Port of ``rtm3d_tpu/data/fast_preproc.py:105-147``
(``transform_labels_affine``), which the device-warp ('raw') mode of the
reader needs: the device resamples the pixels, the host maps the labels by
the same affine. The fused native resample (``FusedPreproc``,
``DATASET.FAST_PREPROC``) is not ported (ROADMAP.md, queue A) and raises.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


class FusedPreproc:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "DATASET.FAST_PREPROC (the fused native resample) is not ported yet: ROADMAP.md, queue A"
        )


def transform_labels_affine(labels: Dict, M: np.ndarray, mirrored: bool, out_size) -> Dict:
    """Apply a composed axis-aligned affine (2x3) to the label block: bbox
    corner map + re-sort, K focal/principal update, mirror angle/location
    flips, RemoveBadBBox + center-out masking."""
    sw, sh = out_size
    # RemoveBadBBox on the original scale (transforms.py:520-531)
    bw = labels["bbox"][:, 2] - labels["bbox"][:, 0]
    bh = labels["bbox"][:, 3] - labels["bbox"][:, 1]
    labels["mask"] = labels["mask"] & ~((bw <= 2) | (bh <= 2))

    b = labels["bbox"].astype(np.float64)
    c1 = M[:2, :2] @ b[:, 0:2].T + M[:2, 2:3]
    c2 = M[:2, :2] @ b[:, 2:4].T + M[:2, 2:3]
    lo = np.minimum(c1, c2).T  # mirror swaps x1/x2
    hi = np.maximum(c1, c2).T
    labels["bbox"] = np.concatenate([lo, hi], axis=1).astype(np.float32)

    K = labels["K"].astype(np.float64)
    s_eff = abs(M[0, 0])
    K[:, 0] *= s_eff  # fx
    K[:, 4] *= abs(M[1, 1])  # fy
    # principal point maps through the full affine (incl. mirror's
    # cx' = nw - cx; the reference uses width - cx - 1 post-mirror — a
    # half-pixel convention difference the JAX package keeps for exactness)
    pp = M[:2, :2] @ K[:, [2, 5]].T + M[:2, 2:3]
    K[:, 2] = pp[0]
    K[:, 5] = pp[1]
    labels["K"] = K.astype(np.float32)

    if mirrored:
        for key in ("alpha", "ry"):
            a = labels[key]
            labels[key] = np.where(a >= 0, -a + np.pi, -a - np.pi).astype(np.float32)
        labels["loc"] = labels["loc"].copy()
        labels["loc"][:, 0] *= -1

    # affine center-out mask (transforms.py:365-369), in the padded frame
    cx = (labels["bbox"][:, 0] + labels["bbox"][:, 2]) / 2
    cy = (labels["bbox"][:, 1] + labels["bbox"][:, 3]) / 2
    out_of = (cx < 0) | (cx >= sw) | (cy < 0) | (cy >= sh)
    labels["mask"] = labels["mask"] & ~out_of
    return labels
