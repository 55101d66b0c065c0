"""Synthetic mini-KITTI generator: a dataset tree in KITTI's exact layout.

Port of ``rtm3d_tpu/data/synthetic.py:30-104``. It writes
``ImageSets/{train,test}.txt`` and ``training/{image_2,label_2,calib}``:
3D boxes sampled in the camera frustum, their projections as the 2D boxes,
and a filled box with a centre dot drawn where each projects. For the same
arguments it writes the same label and calib text, byte for byte, and the
same pixels as the JAX package's generator: the draws come from one
``np.random.RandomState(seed)`` in the same order, the projection is the
port's ``geometry/projection.py::proj2d_bbox3d`` on float64 CPU tensors,
and the drawing goes through ``data/image_io.py``.

    python -m rtm3d_tpu_torch.data.synthetic ROOT [--train N] [--test N] [--hw H W]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from rtm3d_tpu_torch.data import image_io
from rtm3d_tpu_torch.geometry.projection import proj2d_bbox3d

# (h, w, l) priors per generated class
_DIMS = {
    "Car": (1.53, 1.63, 3.88),
    "Pedestrian": (1.76, 0.66, 0.84),
    "Cyclist": (1.74, 0.60, 1.76),
    "Van": (2.21, 1.90, 5.08),
}


def generate_kitti(
    root: str,
    num_train: int = 8,
    num_test: int = 4,
    img_hw=(192, 256),
    max_objs: int = 5,
    seed: int = 20,
    images: bool = True,
) -> str:
    """Write a synthetic KITTI tree under ``root``. Returns ``root``. With
    ``images=False`` it writes labels and calibs only and draws no pixels,
    so its labels are those of another draw than the tree with images."""
    rng = np.random.RandomState(seed)
    H, W = img_hw
    os.makedirs(os.path.join(root, "ImageSets"), exist_ok=True)
    for sub in ("image_2", "label_2", "calib") if images else ("label_2", "calib"):
        os.makedirs(os.path.join(root, "training", sub), exist_ok=True)

    f = 0.7 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2 - 10], [0, 0, 1.0]], np.float32)
    K64 = torch.from_numpy(K.astype(np.float64))[None]

    names = [f"{i:06d}" for i in range(num_train + num_test)]
    for name in names:
        if images:
            img = (rng.rand(H, W, 3) * 40 + 90).astype(np.uint8)
            # ground/sky gradient for texture
            img[: H // 2] = (img[: H // 2].astype(np.int32) + 40).clip(0, 255)
        lines = []
        n = rng.randint(1, max_objs + 1)
        for _ in range(n):
            cls_name = ["Car", "Car", "Pedestrian", "Cyclist", "Van"][rng.randint(5)]
            h, w, l = _DIMS[cls_name]
            h *= rng.uniform(0.9, 1.1)
            w *= rng.uniform(0.9, 1.1)
            l *= rng.uniform(0.9, 1.1)
            z = rng.uniform(8, 35)
            x = rng.uniform(-0.35, 0.35) * z
            y = 1.65 - h / 2 + rng.uniform(-0.1, 0.1)  # on the ground plane
            ry = rng.uniform(-np.pi, np.pi)
            _, bbox2d, _ = proj2d_bbox3d(
                torch.tensor([[h, w, l]], dtype=torch.float64),
                torch.tensor([[x, y + h / 2, z]], dtype=torch.float64),  # KITTI loc = bottom center
                torch.tensor([ry], dtype=torch.float64),
                K64,
            )
            x1, y1, x2, y2 = bbox2d[0].tolist()
            x1c, y1c = max(0.0, x1), max(0.0, y1)
            x2c, y2c = min(W - 1.0, x2), min(H - 1.0, y2)
            if x2c - x1c < 6 or y2c - y1c < 6:
                continue
            if images:  # a filled box + centre dot so the image carries signal
                color = tuple(int(c) for c in rng.randint(120, 255, 3))
                image_io.fill_rectangle(img, (int(x1c), int(y1c)), (int(x2c), int(y2c)), color)
                image_io.fill_circle(img, (int((x1c + x2c) / 2), int((y1c + y2c) / 2)), 2, (255, 255, 255))
            alpha = ry - np.arctan2(x, z)
            lines.append(
                f"{cls_name} 0.00 0 {alpha:.2f} {x1c:.2f} {y1c:.2f} {x2c:.2f} "
                f"{y2c:.2f} {h:.2f} {w:.2f} {l:.2f} {x:.2f} {y + h / 2:.2f} {z:.2f} {ry:.2f}"
            )
        if images:
            image_io.imwrite_png(os.path.join(root, "training", "image_2", f"{name}.png"), img)
        with open(os.path.join(root, "training", "label_2", f"{name}.txt"), "w") as fh:
            fh.write("\n".join(lines) + ("\n" if lines else ""))
        P2 = np.hstack([K, np.zeros((3, 1), np.float32)])
        with open(os.path.join(root, "training", "calib", f"{name}.txt"), "w") as fh:
            fh.write("P2: " + " ".join(f"{v:.6e}" for v in P2.flatten()) + "\n")

    with open(os.path.join(root, "ImageSets", "train.txt"), "w") as fh:
        fh.write("\n".join(names[:num_train]) + "\n")
    with open(os.path.join(root, "ImageSets", "test.txt"), "w") as fh:
        fh.write("\n".join(names[num_train:]) + "\n")
    return root


def main(argv=None) -> None:
    p = argparse.ArgumentParser("rtm3d_tpu_torch synthetic KITTI tree")
    p.add_argument("root")
    p.add_argument("--train", type=int, default=8, help="train frames")
    p.add_argument("--test", type=int, default=4, help="test frames")
    p.add_argument("--hw", type=int, nargs=2, default=(375, 1242), help="frame height and width (KITTI's by default)")
    p.add_argument("--max-objs", type=int, default=8)
    p.add_argument("--seed", type=int, default=20)
    a = p.parse_args(argv)
    generate_kitti(a.root, a.train, a.test, tuple(a.hw), a.max_objs, a.seed)


if __name__ == "__main__":
    main()
