"""Gaussian target math for keypoint heatmaps, on tensors.

Port of ``rtm3d_tpu/geometry/gaussian.py:26-69``; reference semantics:
utils/data_utils.py:89-124. The CornerNet radius keeps the reference's
exact formulation, including the quirk that r2 and r3 are NOT divided by
their quadratic coefficient (data_utils.py:97-118): the loss targets of
trained checkpoints depend on it.
"""

from __future__ import annotations

import torch


def compute_gaussian_radius(bboxes: torch.Tensor, min_overlap: float = 0.7) -> torch.Tensor:
    """CornerNet 3-case min-overlap radius. bboxes: (..., 4) xyxy (feature px)."""
    height = torch.ceil(bboxes[..., 3] - bboxes[..., 1])
    width = torch.ceil(bboxes[..., 2] - bboxes[..., 0])

    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt(torch.clamp(b1**2 - 4 * c1, min=0.0))) / 2

    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + torch.sqrt(torch.clamp(b2**2 - 16 * c2, min=0.0))) / 2  # quirk: not /(2*a2)

    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + torch.sqrt(torch.clamp(b3**2 - 4 * a3 * c3, min=0.0))) / 2  # quirk: not /(2*a3)

    return torch.minimum(torch.minimum(r1, r2), r3)


def dynamic_radius(bboxes: torch.Tensor):
    """sigma, radius from the CornerNet radius (data_utils.py:121-124)."""
    radius = compute_gaussian_radius(bboxes)
    return (2 * radius + 1) / 6, torch.ceil(radius)


def dynamic_sigma(bboxes: torch.Tensor, max_bbox_area: float, min_bbox_area: float,
                  max_sigma: float = 19.0, min_sigma: float = 3.0, down_ratio: float = 4.0):
    """Area-interpolated sigma (data_utils.py:89-94)."""
    scale = (max_sigma - min_sigma) / (max_bbox_area - min_bbox_area) * down_ratio**2
    areas = (bboxes[..., 2] - bboxes[..., 0]) * (bboxes[..., 3] - bboxes[..., 1])
    sigma = torch.sqrt(torch.clamp((areas - min_bbox_area) * scale + min_sigma, min=0.0))
    return sigma, torch.ceil(sigma * 3)
