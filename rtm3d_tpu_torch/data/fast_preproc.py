"""Fused host preprocessing: one affine warp for the whole geometric chain.

Port of ``rtm3d_tpu/data/fast_preproc.py``. The cv2 path of the reader
(``data/transforms.py``) resamples an image several times: resize, the
scale augmentation's warp, the mirror copy, the pad copy. Here the chain
resize -> random affine -> mirror -> pad composes into ONE 2x3 matrix and the
image is resampled once by the host C++ library (``data/native.py``,
``csrc/preproc.cc``: bilinear, border fill and normalisation fused), and the
labels (bbox, K, angles) go through the same matrix
(``transform_labels_affine``, which the device-warp mode of the reader uses
too). ``DATASET.FAST_PREPROC`` selects it (``data/kitti.py``).

The draws come from the caller's ``np.random.RandomState`` in the JAX
package's order, so one stream gives the same samples in both packages.
Photometric augmentation (brightness/contrast, Gaussian noise) runs on the
uint8 source before the warp.

On an H100's host it is slower than the cv2 path, not faster: a DLA-34
batch of 16 KITTI frames took 1.27-1.37 s against cv2's 0.96-1.22 s on one
thread (``PERF.md`` section 5): the library's scalar loop writes float32.
A vectorised warp, or one that writes uint8 for the device's
normalisation, is the open item (``ROADMAP.md`` queue A).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from rtm3d_tpu_torch.data import native

# the training augmentation's draws, as the cv2 path's Compose has them
SCALE_RANGE = (1.0, 1.2)
AFFINE_P = 0.5
MIRROR_P = 0.5


class FusedPreproc:
    """The Compose pipelines plus padding in one: returns the padded,
    normalised float32 image and the transformed labels. Builds (or loads)
    the host library when constructed, so that forked loader workers
    inherit it."""

    def __init__(
        self,
        out_size: Tuple[int, int],  # (W, H) final padded size
        resize_max_side: int,
        mean,
        std,
        train: bool = True,
    ):
        self.out_size = out_size
        self.resize_max_side = resize_max_side
        self.mean = np.asarray(mean, np.float32).reshape(3)
        self.std = np.asarray(std, np.float32).reshape(3)
        self.train = train
        native.load_library()

    def __call__(self, img: np.ndarray, labels: Optional[Dict], rng) -> tuple:
        h0, w0 = img.shape[:2]
        sw, sh = self.out_size

        # photometric on the uint8 source, before the warp
        if self.train:
            if rng.rand() < 0.5:  # brightness/contrast
                alpha = 1.0 + rng.uniform(-0.2, 0.2)
                beta = rng.uniform(-0.2, 0.2)
                img = np.clip(img.astype(np.float32) * alpha + beta * 255.0, 0, 255).astype(np.uint8)
            if rng.rand() < 0.5:  # Gaussian noise
                var = rng.uniform(10.0, 50.0)
                img = np.clip(img.astype(np.float32) + rng.normal(0, var**0.5, img.shape), 0, 255).astype(np.uint8)

        # the geometric chain as one affine
        r = self.resize_max_side / max(h0, w0)
        nw, nh = int(w0 * r), int(h0 * r)
        M = np.array([[r, 0, 0], [0, r, 0], [0, 0, 1]], np.float64)
        if self.train and rng.rand() < AFFINE_P:
            scale = rng.uniform(*SCALE_RANGE)
            off = (np.array([nw, nh], np.float64) * (1 - scale)) / 2.0
            M = np.array([[scale, 0, off[0]], [0, scale, off[1]], [0, 0, 1]]) @ M
        mirrored = self.train and rng.rand() < MIRROR_P
        if mirrored:
            # x' = nw - x (reference box convention, transforms.py:455-459)
            M = np.array([[-1, 0, nw], [0, 1, 0], [0, 0, 1]], np.float64) @ M
        pad_w, pad_h = (sw - nw) // 2, (sh - nh) // 2
        M = np.array([[1, 0, pad_w], [0, 1, pad_h], [0, 0, 1]], np.float64) @ M

        # one fused resample + normalise
        border = img.reshape(-1, 3).mean(axis=0).astype(np.float32)
        out = native.warp_normalize(img, M[:2].astype(np.float32), (sh, sw), self.mean, self.std, border=border)
        if labels is not None:
            labels = transform_labels_affine(labels, M, mirrored, (sw, sh))
        return out, labels


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


def available() -> bool:
    """True: the port builds its own library at first use, and a failed
    build raises rather than answering False."""
    native.load_library()
    return True
