"""Batched heatmap decode: sigmoid -> 3x3 peak NMS -> top-K -> vertex assembly.

Port of ``rtm3d_tpu/decode/peaks.py:22-112``; reference semantics:
models/model.py:29-98 + utils/model_utils.py:17-26. Branch-free over the
batch: max-pool peak suppression, a fixed top-K with a validity mask instead
of the reference's dynamic ``scores > thresh`` filter, batched gathers.

Outputs are fixed-shape (B, K, ...) tensors + ``valid`` bits, in input-image
pixels (already scaled by DOWN_SAMPLE). Logits come in NCHW.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from rtm3d_tpu_torch.utils.profiling import span


def nms_peaks(hm: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """Keep pixels that equal their 3x3 max (model_utils.py:17-26). NCHW."""
    hmax = F.max_pool2d(hm, kernel, stride=1, padding=(kernel - 1) // 2)
    # a Python scalar, not a tensor made on hm's device: torch.export would
    # record that device in the graph (cli/export.py serves one graph on
    # every platform it lists)
    return torch.where(hmax == hm, hm, 0.0)


def decode_detections(
    logits: Sequence[torch.Tensor],
    score_thresh: float = 0.4,
    topk: int = 100,
    down_sample: float = 4.0,
) -> Dict[str, torch.Tensor]:
    """logits: NCHW (main_kf, offset_fr_main, main_offset, vertex_offset).

    Returns dict:
      cls (B,K) int32, scores (B,K), valid (B,K) bool,
      m_proj (B,K,2) centers in input px (sub-pixel),
      v_proj (B,K,8,2) regressed vertices in input px,
      bbox2d (B,K,4) xyxy from vertex min/max.
    Top-K is exact (``torch.topk``), the reference's semantics.
    """
    with span("detect.decode"):
        main_kf, offset_fr_main, main_offset, _vertex_offset = (l.float() for l in logits)
        B, C, H, W = main_kf.shape
        hm = nms_peaks(torch.sigmoid(main_kf))

        # index = c*H*W + y*W + x, the reference's flatten order (model.py:88-97)
        scores, indices = torch.topk(hm.reshape(B, C * H * W), topk, dim=1)
        valid = scores > score_thresh
        cls = torch.div(indices, H * W, rounding_mode="floor")
        xy = indices % (H * W)
        y = torch.div(xy, W, rounding_mode="floor")
        x = xy % W

        def gather(fmap):
            # fmap (B, C', H, W) at the peaks -> (B, K, C')
            flat = fmap.reshape(B, fmap.shape[1], H * W)
            idx = xy[:, None, :].expand(B, fmap.shape[1], topk)
            return torch.gather(flat, 2, idx).transpose(1, 2)

        # 16-ch vertex offsets at peaks: channel pairs are (dx, dy) per vertex
        # (model.py:117-132 view(-1, 2, N) semantics)
        offs = gather(offset_fr_main).reshape(B, topk, 8, 2)
        # sub-pixel center offset (model.py:48-50)
        sub = torch.sigmoid(gather(main_offset))
        centers = torch.stack([x, y], dim=-1).float() + sub

        v_proj = (offs + centers[:, :, None, :]) * down_sample
        m_proj = centers * down_sample
        bbox2d = torch.cat([v_proj.amin(dim=2), v_proj.amax(dim=2)], dim=-1)
        return {
            "cls": cls.to(torch.int32),
            "scores": scores,
            "valid": valid,
            "m_proj": m_proj,
            "v_proj": v_proj,
            "bbox2d": bbox2d,
        }
