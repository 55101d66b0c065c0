"""Every image read, write, draw and host resample of the port, in one module.

OpenCV is on the GPU machine (cv2 4.13) as it is where the JAX package
runs, so each function calls cv2 exactly as the JAX package does
(``rtm3d_tpu/data/kitti.py:31,167,282-289,349``, ``transforms.py:97,125,137,214-222``,
``synthetic.py:78-93``), and the port's host pipeline is bit-exact with
it. ``cv2.setNumThreads(0)`` keeps cv2's own thread pool out of the
loader's forked workers (``kitti.py:31``).

Images are HWC uint8 in OpenCV's BGR channel order, as the reference
keeps them (dataset_reader.py:128-131).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import cv2
import numpy as np

cv2.setNumThreads(0)


def imread(path: str) -> np.ndarray:
    """(H, W, 3) uint8 BGR; raises ``FileNotFoundError`` when unreadable."""
    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return img


def imwrite_png(path: str, img: np.ndarray) -> None:
    if not cv2.imwrite(path, img):
        raise OSError(f"could not write {path}")


def mean_color(img: np.ndarray) -> np.ndarray:
    """Per-channel mean, (3,) float64 (``np.array(cv2.mean(img))[:3]``)."""
    return np.array(cv2.mean(img))[:3]


def resize_linear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize to ``size`` = (width, height)."""
    return cv2.resize(img, dsize=tuple(size), interpolation=cv2.INTER_LINEAR)


def warp_affine_linear(img: np.ndarray, M: np.ndarray, size: Tuple[int, int],
                       border_value: Sequence[float]) -> np.ndarray:
    """Bilinear affine warp by the 2x3 ``M`` to ``size`` = (width, height);
    pixels from outside the source take ``border_value``."""
    return cv2.warpAffine(img, M, dsize=tuple(size), flags=cv2.INTER_LINEAR,
                          borderValue=tuple(float(v) for v in border_value))


def rotation_matrix(angle: float, center: Tuple[float, float], scale: float) -> np.ndarray:
    """The 2x3 rotation by ``angle`` degrees about ``center`` with ``scale``
    (``cv2.getRotationMatrix2D``)."""
    return cv2.getRotationMatrix2D(angle=angle, center=center, scale=scale)


def fill_rectangle(img: np.ndarray, p1: Tuple[int, int], p2: Tuple[int, int], color) -> None:
    """Filled axis-aligned rectangle between corners ``p1`` and ``p2``, in place."""
    cv2.rectangle(img, p1, p2, color, thickness=-1)


def fill_circle(img: np.ndarray, center: Tuple[int, int], radius: int, color) -> None:
    """Filled circle, in place."""
    cv2.circle(img, center, radius, color, -1)


# -- the detection drawings of utils/visual.py, as the JAX package draws them
# (rtm3d_tpu/utils/visual.py): cv2's calls with its arguments, in place --
FONT_SIMPLEX, FONT_PLAIN, LINE_8, LINE_AA = cv2.FONT_HERSHEY_SIMPLEX, cv2.FONT_HERSHEY_PLAIN, cv2.LINE_8, cv2.LINE_AA


def rectangle(img, p1, p2, color, thickness: int = 1, line_type: int = LINE_8) -> None:
    cv2.rectangle(img, p1, p2, color, thickness, line_type)


def line(img, p1, p2, color, thickness: int = 1) -> None:
    cv2.line(img, p1, p2, color, thickness)


def polylines(img, points: np.ndarray, closed: bool, color, thickness: int = 1) -> None:
    cv2.polylines(img, [points], closed, color, thickness)


def fill_poly(img, points: np.ndarray, color) -> None:
    cv2.fillPoly(img, [points], color)


def blend(img, overlay, alpha: float) -> None:
    """``img = (1 - alpha) img + alpha overlay``, rounded as cv2 rounds."""
    cv2.addWeighted(img, 1.0 - alpha, overlay, alpha, 0.0, dst=img)


def put_text(img, text: str, org, font: int, scale: float, color, thickness: int = 1,
             line_type: int = LINE_8) -> None:
    cv2.putText(img, text, org, font, scale, color, thickness, line_type)


def text_size(text: str, font: int, scale: float, thickness: int) -> Tuple[int, int]:
    """(width, height) of ``text`` drawn by ``put_text``."""
    return cv2.getTextSize(text, font, fontScale=scale, thickness=thickness)[0]
