"""Host-side numpy augmentation pipeline (runs in the loader's workers).

Port of ``rtm3d_tpu/data/transforms.py:32-304``; reference
semantics: preprocess/transforms.py + preprocess/data_preprocess.py. Each
transform is ``(img, labels, rng, **params) -> (img, labels)`` over a
plain dict of numpy arrays:
  cls (N,), bbox (N,4) xyxy px, dim (N,3), alpha (N,), ry (N,), loc (N,3),
  K (N,9), mask (N,), noise_mask (N,)
Geometric transforms keep the intrinsics K consistent as the reference
does (ToPercent/ToAbsolute rescale K rows, transforms.py:146-176;
RandomAffine updates focal and principal point, :325-369; RandomMirror
flips cx and the alpha/Ry angles and negates x, :448-477).
RemoveBadBBox zeroes ``mask`` instead of deleting rows (fixed shapes).

The draws come from the caller's ``np.random.RandomState`` in the JAX
package's order, each only where the JAX transform makes it (a
probability draw first, then the parameters when it passes), so one
shared per-batch stream gives the same samples in both packages. Pixels
go through ``data/image_io.py`` (cv2), the mosaic homography
``RandomAffine2D`` (``:177-250``) included.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from rtm3d_tpu_torch.data import image_io

Labels = Dict[str, np.ndarray]


class Compose:
    def __init__(self, transforms: List[Callable]):
        self.transforms = transforms

    def __call__(self, img, labels: Optional[Labels] = None, rng=None, **params):
        if rng is None:
            # the JAX package's deterministic default: rng-less calls replay
            # the same draws; the dataset and loader always pass their own
            rng = np.random.RandomState(20)
        for t in self.transforms:
            img, labels = t(img, labels, rng=rng, **params)
        return img, labels


class Normalize:
    """img/255 - mean / std (transforms.py:110-120)."""

    def __call__(self, img, labels=None, rng=None, mean_rgb=None, std_rgb=None, **kw):
        img = img.astype(np.float32) / 255.0
        if mean_rgb is not None:
            img = img - mean_rgb
        if std_rgb is not None:
            img = img / std_rgb
        return img, labels


class ToPercentCoords:
    def __call__(self, img, labels=None, rng=None, **kw):
        h, w = img.shape[:2]
        if labels is not None:
            labels["bbox"][:, 0::2] /= w
            labels["bbox"][:, 1::2] /= h
            labels["K"][:, :3] /= w
            labels["K"][:, 3:6] /= h
        return img, labels


class ToAbsoluteCoords:
    def __call__(self, img, labels=None, rng=None, **kw):
        h, w = img.shape[:2]
        if labels is not None:
            labels["bbox"][:, 0::2] *= w
            labels["bbox"][:, 1::2] *= h
            labels["K"][:, :3] *= w
            labels["K"][:, 3:6] *= h
        return img, labels


class Resize:
    """Keep-aspect resize so max side == size (transforms.py:480-495).
    Box/K rescaling is handled by the surrounding ToPercent/ToAbsolute pair."""

    def __init__(self, size):
        self.size = size

    def __call__(self, img, labels=None, rng=None, **kw):
        h, w = img.shape[:2]
        if isinstance(self.size, (tuple, list)):
            size = tuple(self.size)
        else:
            rate = self.size / max(h, w)
            size = (int(w * rate), int(h * rate))
        return image_io.resize_linear(img, size), labels


class RemoveBadBBox:
    """Mask out boxes with w<=2 or h<=2 (transforms.py:520-531)."""

    def __call__(self, img, labels=None, rng=None, **kw):
        if labels is not None:
            w = labels["bbox"][:, 2] - labels["bbox"][:, 0]
            h = labels["bbox"][:, 3] - labels["bbox"][:, 1]
            labels["mask"] = labels["mask"] & ~((w <= 2) | (h <= 2))
        return img, labels


class RandomAffine:
    """Scale + centered offset with K update (transforms.py:325-369).
    p=0.5; scale ~ U(range); objects whose center leaves the image get
    mask=0."""

    def __init__(self, scale_range=(1.0, 1.2), offset=0.0, p=0.5):
        self.scale_range = scale_range
        self.offset = offset
        self.p = p

    def __call__(self, img, labels=None, rng=None, **kw):
        h, w = img.shape[:2]
        if rng.rand() < self.p:
            mean = image_io.mean_color(img)
            if isinstance(self.scale_range, (tuple, list)):
                scale = rng.uniform(self.scale_range[0], self.scale_range[1])
            else:
                scale = (2 * rng.rand() - 1.0) * self.scale_range + 1.0
            base_offset = (np.array([w, h], np.float32) * (1 - scale)) / 2.0
            offset = (2 * rng.random_sample(2) - 1) * self.offset * np.abs(
                base_offset
            ) + base_offset
            M = np.eye(3)
            M[:2, :2] *= scale
            M[:2, 2] = offset
            img = image_io.warp_affine_linear(img, M[:2], (w, h), mean)
            if labels is not None:
                labels["bbox"] *= scale
                labels["bbox"][:, 0::2] += offset[0]
                labels["bbox"][:, 1::2] += offset[1]
                labels["K"][:, :3] *= scale
                labels["K"][:, 3:6] *= scale
                labels["K"][:, 2] += offset[0]
                labels["K"][:, 5] += offset[1]
        if labels is not None and "mask" in labels:
            cx = (labels["bbox"][:, 0] + labels["bbox"][:, 2]) / 2
            cy = (labels["bbox"][:, 1] + labels["bbox"][:, 3]) / 2
            out = (cx < 0) | (cx >= w) | (cy < 0) | (cy >= h)
            labels["mask"] = labels["mask"] & ~out
        return img, labels


class RandomMirror:
    """Horizontal flip with angle/location consistency (transforms.py:448-477)."""

    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, img, labels=None, rng=None, **kw):
        h, w = img.shape[:2]
        if rng.rand() < self.p:
            img = np.ascontiguousarray(img[:, ::-1])
            if labels is not None:
                b = labels["bbox"]
                labels["bbox"] = np.stack(
                    [w - b[:, 2], b[:, 1], w - b[:, 0], b[:, 3]], axis=-1
                )
                labels["K"][:, 2] = w - labels["K"][:, 2] - 1
                for key in ("alpha", "ry"):
                    a = labels[key]
                    labels[key] = np.where(a >= 0, -a + np.pi, -a - np.pi)
                labels["loc"][:, 0] *= -1
        return img, labels


class RandomAffine2D:
    """Rotation, translation, shear and scale for the mosaic composition
    (reference transforms.py:372-445). Boxes are refit from their 4 warped
    corners; degenerate results (tiny, over-cropped, extreme aspect, center
    outside) are masked out by the reference's criteria. Like the
    reference, K is not updated: rotation and shear are no intrinsics, so
    mosaic is consistent for the 2D targets only."""

    def __call__(self, img, labels=None, rng=None, degrees=0.0, translate=0.0, scale=0.5, shear=0.0, border=None,
                 **kw):
        h, w = img.shape[:2]
        if border is None:
            border = (-h // 4, -w // 4)
        height = h + border[0] * 2
        width = w + border[1] * 2

        R = np.eye(3)
        a = rng.uniform(-degrees, degrees)
        s = rng.uniform(1 - scale, 1 - scale / 2)
        R[:2] = image_io.rotation_matrix(a, (w / 2, h / 2), s)
        T = np.eye(3)
        T[0, 2] = rng.uniform(-translate, translate) * w + border[1]
        T[1, 2] = rng.uniform(-translate, translate) * h + border[0]
        S = np.eye(3)
        S[0, 1] = np.tan(rng.uniform(-shear, shear) * np.pi / 180)
        S[1, 0] = np.tan(rng.uniform(-shear, shear) * np.pi / 180)
        M = S @ T @ R  # the reference's order (transforms.py:405)

        img = image_io.warp_affine_linear(img, M[:2], (width, height), (114, 114, 114))
        if labels is not None and "mask" in labels:
            bboxes = labels["bbox"].copy()
            n = len(bboxes)
            if n:
                xy = np.ones((n * 4, 3))
                xy[:, :2] = bboxes[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n * 4, 2)
                xy = (xy @ M.T)[:, :2].reshape(n, 8)
                x = xy[:, [0, 2, 4, 6]]
                y = xy[:, [1, 3, 5, 7]]
                new = np.stack([x.min(1), y.min(1), x.max(1), y.max(1)], axis=1)
                bw = new[:, 2] - new[:, 0]
                bh = new[:, 3] - new[:, 1]
                area0 = (bboxes[:, 2] - bboxes[:, 0]) * (bboxes[:, 3] - bboxes[:, 1])
                ar = np.maximum(bw / (bh + 1e-16), bh / (bw + 1e-16))
                keep = (bw > 2) & (bh > 2) & (bw * bh / (area0 * s + 1e-16) > 0.2) & (ar < 20)
                labels["mask"] = labels["mask"] & keep
                bboxes[keep] = new[keep]
                cx = bboxes[:, 0::2].sum(axis=1) * 0.5
                cy = bboxes[:, 1::2].sum(axis=1) * 0.5
                out = (cx < 0) | (cx >= width) | (cy < 0) | (cy >= height)
                labels["mask"] = labels["mask"] & ~out
                labels["bbox"] = bboxes
        return img, labels


class RandomBrightnessContrast:
    """albumentations-equivalent: brightness/contrast jitter +-0.2, p=0.5."""

    def __init__(self, limit=0.2, p=0.5):
        self.limit = limit
        self.p = p

    def __call__(self, img, labels=None, rng=None, **kw):
        if rng.rand() < self.p:
            alpha = 1.0 + rng.uniform(-self.limit, self.limit)  # contrast
            beta = rng.uniform(-self.limit, self.limit)  # brightness
            f = img.astype(np.float32) * alpha + beta * 255.0
            img = np.clip(f, 0, 255).astype(img.dtype)
        return img, labels


class GaussNoise:
    """albumentations-equivalent: additive gaussian noise, var 10-50, p=0.5."""

    def __init__(self, var_limit=(10.0, 50.0), p=0.5):
        self.var_limit = var_limit
        self.p = p

    def __call__(self, img, labels=None, rng=None, **kw):
        if rng.rand() < self.p:
            var = rng.uniform(*self.var_limit)
            noise = rng.normal(0, var**0.5, img.shape)
            img = np.clip(img.astype(np.float32) + noise, 0, 255).astype(img.dtype)
        return img, labels


def train_augmentation(size) -> Compose:
    """TrainAugmentation preset (data_preprocess.py:4-32)."""
    return Compose(
        [
            RandomBrightnessContrast(p=0.5),
            GaussNoise(p=0.5),
            RemoveBadBBox(),
            ToPercentCoords(),
            Resize(size),
            ToAbsoluteCoords(),
            RandomAffine(scale_range=(1.0, 1.2), offset=0.0),
            RandomMirror(),
        ]
    )


def test_transform(size) -> Compose:
    """TestTransform preset (data_preprocess.py:35-53)."""
    return Compose(
        [RemoveBadBBox(), ToPercentCoords(), Resize(size), ToAbsoluteCoords()]
    )
