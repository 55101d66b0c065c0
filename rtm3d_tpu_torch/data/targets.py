"""On-device, fixed-shape target building.

Port of ``rtm3d_tpu/data/targets.py:35-117``; reference semantics:
datasets/dataset_reader.py:215-291. The loader ships the image and a small
padded label block; the train and eval-loss steps build every loss target
on the device from it. The class heatmap goes through
``ops/splat.py::splat_heatmap`` (the CUDA kernel on the GPU, its plain
version, the port of ``_render_heatmap``, on the CPU).

Layouts are the JAX package's except the heatmap: ``m_hm`` is NCHW
(B, C, H, W), the port's logits layout, where the JAX package's is NHWC.
"""

from __future__ import annotations

from typing import Dict

import torch

from rtm3d_tpu_torch.geometry.box_ops import bbox_center
from rtm3d_tpu_torch.geometry.gaussian import dynamic_radius, dynamic_sigma
from rtm3d_tpu_torch.geometry.projection import proj2d_bbox3d
from rtm3d_tpu_torch.ops.splat import splat_heatmap

# Per image, the loader emits fixed (MAX_OBJS,)-shaped arrays under these
# keys; ``mask`` == 0 marks padding and unknown classes (dataset_reader.py:104-107).
LABEL_KEYS = ("cls", "bbox", "dim", "alpha", "ry", "loc", "K", "mask", "noise_mask")


def heatmap_inputs(
    labels: Dict[str, torch.Tensor],
    down_ratio: float = 4.0,
    gaussian_gen_type: str = "dynamic_radius",
    bbox_area_max: float = 0.2598311523503046,
    bbox_area_min: float = 0.0002022788461538487,
):
    """The splat's inputs from a label block: m_proj (B,N,2) int32, cls
    (B,N) int32, sigma and radius (B,N) float32, mask and noise (B,N) bool,
    contiguous, as ``ops/splat.py::splat_heatmap`` takes them."""
    bbox = labels["bbox"].float() / down_ratio
    mask = labels["mask"].bool().contiguous()
    # .to(int32) truncates toward zero, as the reference's .astype(np.long)
    m_proj = bbox_center(bbox).to(torch.int32)
    if gaussian_gen_type == "dynamic_radius":
        sigma, radius = dynamic_radius(bbox)
    else:
        sigma, radius = dynamic_sigma(bbox, bbox_area_max, bbox_area_min)
    sigma = torch.where(mask & (sigma > 0), sigma, 1.0)  # exp() stays finite on padding
    radius = torch.where(mask, radius, 0.0)
    cls = labels["cls"].to(torch.int32).contiguous()
    return m_proj, cls, sigma, radius, mask, labels["noise_mask"].bool().contiguous()


def build_targets(
    labels: Dict[str, torch.Tensor],
    feat_hw: tuple,
    num_classes: int,
    down_ratio: float = 4.0,
    gaussian_gen_type: str = "dynamic_radius",
    bbox_area_max: float = 0.2598311523503046,
    bbox_area_min: float = 0.0002022788461538487,
) -> Dict[str, torch.Tensor]:
    """All loss targets, on the labels' device.

    labels: cls (B,N) int; bbox (B,N,4) input px; dim (B,N,3); ry (B,N);
    loc (B,N,3); K (B,N,9); mask (B,N); noise_mask (B,N).
    feat_hw: (H, W) of the stride-``down_ratio`` feature map.
    Returns m_hm (B,C,H,W) and the per-slot targets m_proj (B,N,2) int32,
    m_off (B,N,2), v_proj (B,N,8,2) int32, v_off, v_coor_off (B,N,8,2),
    v_mask (B,N,8), mask_3d, mask, noise_mask (B,N).
    """
    H, W = feat_hw
    m_proj, cls, sigma, radius, mask, noise = heatmap_inputs(
        labels, down_ratio, gaussian_gen_type, bbox_area_max, bbox_area_min
    )
    m_hm = splat_heatmap(m_proj, cls, sigma, radius, mask, noise, (H, W), num_classes)
    B, N = cls.shape

    centers = bbox_center(labels["bbox"].float() / down_ratio)  # (B, N, 2)
    m_off = centers - m_proj

    # project the 3D boxes with the downscaled intrinsics (dataset_reader.py:230-238)
    K = labels["K"].float()
    K = torch.cat([K[..., :6] / down_ratio, K[..., 6:]], -1).reshape(B * N, 3, 3)
    uv, _, mask_3d = proj2d_bbox3d(
        labels["dim"].float().reshape(B * N, 3),
        labels["loc"].float().reshape(B * N, 3),
        labels["ry"].float().reshape(B * N),
        K,
    )
    verts = uv.transpose(1, 2)[:, :8].reshape(B, N, 8, 2)
    mask_3d = mask_3d.reshape(B, N) & mask  # padded slots are never 3D-valid
    # truncation toward zero again: vertices can be negative, and floor
    # would move v_mask and v_off
    v_proj = verts.to(torch.int32)
    v_off = verts - v_proj
    v_coor_off = verts - centers[:, :, None, :]
    v_mask = (v_proj[..., 0] >= 0) & (v_proj[..., 0] < W) & (v_proj[..., 1] >= 0) & (v_proj[..., 1] < H)

    return {
        "m_hm": m_hm,
        "m_proj": m_proj,
        "m_off": m_off,
        "v_proj": v_proj,
        "v_off": v_off,
        "v_coor_off": v_coor_off,
        "v_mask": v_mask,
        "mask_3d": mask_3d,
        "mask": mask,
        "noise_mask": noise,
    }
