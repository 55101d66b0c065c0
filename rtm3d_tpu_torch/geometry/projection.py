"""Camera geometry on tensors: yaw rotations, 3D box corners, projection.

Port of ``rtm3d_tpu/geometry/projection.py:43-116``, the torch path only,
and of its class-name mapping (``:124-145``, plain Python).
``proj2d_bbox3d`` stands in for the reference's missing devkit call
``calc_proj2d_bbox3d`` (datasets/dataset_reader.py:9-11), re-derived from
the corner and projection math of utils/model_utils.py:66-152.

Conventions (KITTI camera frame): x right, y down, z forward; dimension =
(h, w, l); corners put l/2 along x, h/2 along y, w/2 along z, in the sign
order of the reference loops ``for i in [1,-1]: for j in [1,-1]: for k in
[1,-1]`` (model_utils.py:102-111), plus a 9th point at the box center.
"""

from __future__ import annotations

import torch

CORNER_SIGNS = torch.tensor(
    [[i, j, k] for i in (1, -1) for j in (1, -1) for k in (1, -1)] + [[0, 0, 0]],
    dtype=torch.float32,
).T  # (3, 9)


def rotation_y(ry: torch.Tensor) -> torch.Tensor:
    """Yaw rotation matrices. ry: (...,) -> (..., 3, 3)."""
    s, c = torch.sin(ry), torch.cos(ry)
    zeros, ones = torch.zeros_like(s), torch.ones_like(s)
    return torch.stack(
        [
            torch.stack([c, zeros, s], -1),
            torch.stack([zeros, ones, zeros], -1),
            torch.stack([-s, zeros, c], -1),
        ],
        -2,
    )


def corners_3d(dimension: torch.Tensor, location: torch.Tensor, ry: torch.Tensor,
               bottom_center: bool = False) -> torch.Tensor:
    """3D corners of yaw-rotated boxes, (..., 3, 9): 8 corners + center.

    dimension (..., 3) = (h, w, l); location (..., 3); ry (...,).
    ``bottom_center=True`` reads location as the KITTI bottom-face center
    (the box center sits h/2 above it); False as the geometric center.
    """
    signs = CORNER_SIGNS.to(dimension)
    half = torch.stack([dimension[..., 2], dimension[..., 0], dimension[..., 1]], -1) * 0.5
    rotated = torch.matmul(rotation_y(ry), half[..., :, None] * signs)
    center = location
    if bottom_center:
        zero = torch.zeros_like(dimension[..., 0])
        center = location + torch.stack([zero, -dimension[..., 0] * 0.5, zero], -1)
    return rotated + center[..., :, None]


def proj2d_bbox3d(dimension: torch.Tensor, location: torch.Tensor, ry: torch.Tensor,
                  K: torch.Tensor, eps: float = 1e-6, bottom_center: bool = True):
    """Project 3D boxes to the image.

    dimension (N, 3) (h, w, l); location (N, 3), KITTI bottom-center by
    default; ry (N,); K (N, 3, 3). Returns verts_uv (N, 2, 9) (8 corners +
    center), bboxes_2d (N, 4) xyxy over the 8 corners, and mask_3d (N,)
    (box in front of the camera, z > 0).
    """
    pts = corners_3d(dimension, location, ry, bottom_center=bottom_center)
    proj = torch.matmul(K, pts)
    uv = proj[:, :2, :] / (proj[:, 2:3, :] + eps)
    corners = uv[:, :, :8]
    bboxes_2d = torch.cat([corners.amin(2), corners.amax(2)], -1)
    return uv, bboxes_2d, location[:, 2] > 0


# KITTI class names <-> integer labels in the devkit's order: the port's
# copy of rtm3d_tpu/geometry/projection.py:124-145 (the reference calls
# ``kitti_util.name_2_label(cfg.DATASET.OBJs)``, dataset_reader.py:22-23).
KITTI_NAMES = [
    "Car",
    "Van",
    "Truck",
    "Pedestrian",
    "Person_sitting",
    "Cyclist",
    "Tram",
    "Misc",
    "DontCare",
]


def name_2_label(names):
    """Map name(s) to devkit integer labels; nested lists map elementwise."""
    if isinstance(names, str):
        return KITTI_NAMES.index(names)
    return [name_2_label(n) for n in names]


def label_2_name(label: int) -> str:
    return KITTI_NAMES[label]
