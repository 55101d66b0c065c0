"""2D box math on tensors.

Port of ``rtm3d_tpu/geometry/box_ops.py`` (``bbox_center``), the torch path
only; reference semantics: utils/data_utils.py:7-40.
"""

from __future__ import annotations

import torch


def bbox_center(x: torch.Tensor) -> torch.Tensor:
    """[x1,y1,x2,y2] -> [xc,yc]; x: (..., 4) -> (..., 2)."""
    return (x[..., 0:2] + x[..., 2:4]) * 0.5
