"""RTM3D training loss: fixed-shape and mask-based.

Port of ``rtm3d_tpu/losses/rtm3d_loss.py:29-125``; reference semantics:
models/rtm3d_loss.py:268-340. Every gather of predictions at ground-truth
pixels is a fixed-size batched gather with its indices clipped to the map
(the masks drop those rows), and every ``F.l1_loss(x[sel], y[sel])``
becomes ``sum(|x - y| * w) / (2 * count(w))``: the same value, a static
shape, and 0 (the reference gives NaN) for an empty selection.

Terms and weights (detault.py:15-19): MKF focal on the center heatmap,
VFM L1 on the 16-channel vertex-from-center offsets (raw), M_OFF and V_OFF
L1 on the sigmoid sub-pixel center and vertex offsets. The aux vector is
[MKF, VFM, M_OFF, V_OFF, total] (train.py:108-112).

Logits come in the port's layout, NCHW; targets from ``data/targets.py``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from rtm3d_tpu_torch.losses.focal import focal_loss, sigmoid_hm


def _gather_pixels(fmap: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """fmap (B, C, H, W); xy (B, ..., 2) int -> (B, ..., C), indices clipped."""
    B, C, H, W = fmap.shape
    x = xy[..., 0].long().clamp(0, W - 1)
    y = xy[..., 1].long().clamp(0, H - 1)
    idx = (y * W + x).reshape(B, 1, -1).expand(B, C, -1)  # (B, C, M)
    out = fmap.reshape(B, C, H * W).gather(2, idx)
    return out.transpose(1, 2).reshape(xy.shape[:-1] + (C,))


def _masked_mean_l1(pred: torch.Tensor, tgt: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Mean |pred - tgt| over the rows where w, every component counted."""
    w = w.to(pred.dtype)
    num = (torch.abs(pred - tgt) * w[..., None]).sum()
    den = w.sum() * pred.shape[-1]
    return torch.where(den > 0, num / torch.clamp(den, min=1.0), 0.0)


def rtm3d_loss(
    logits: Sequence[torch.Tensor],
    targets: Dict[str, torch.Tensor],
    w_mkf: float = 1.0,
    w_vfm: float = 1.0,
    w_m_off: float = 0.5,
    w_v_off: float = 0.5,
    focal_alpha: float = 2.0,
    focal_beta: float = 4.0,
    sample_mask: torch.Tensor | None = None,
):
    """logits: NCHW (m_hm_pred, ver_coor_pred, m_off_pred, v_off_pred).

    Returns (loss, aux[5]); aux = [MKF, VFM, M_OFF, V_OFF, total], detached.
    ``sample_mask``: optional (B,) bool; False rows are left out of every
    term's sums and counts, so the result is the loss of the valid rows
    alone (the reference's test_epoch averages true batches, train.py:61-81).
    """
    m_hm_pred, ver_coor_pred, m_off_pred, v_off_pred = (l.float() for l in logits)
    mask, noise = targets["mask"], targets["noise_mask"]
    m_proj, v_proj, v_mask = targets["m_proj"], targets["v_proj"], targets["v_mask"]

    # main keypoint focal (rtm3d_loss.py:285)
    loss_mkf = focal_loss(sigmoid_hm(m_hm_pred), targets["m_hm"], focal_alpha, focal_beta,
                          sample_mask=sample_mask)

    ofm_valid = mask & ~noise & targets["mask_3d"]  # (B, N) (rtm3d_loss.py:300)
    m_valid = mask & ~noise
    if sample_mask is not None:
        ofm_valid = ofm_valid & sample_mask[:, None]
        m_valid = m_valid & sample_mask[:, None]
    w_vc = ofm_valid[..., None] & v_mask  # (B, N, 8)

    # vertex-from-center coordinates at the gt centers, raw (rtm3d_loss.py:303-310)
    B, N = m_proj.shape[:2]
    vc_pred = _gather_pixels(ver_coor_pred, m_proj).reshape(B, N, 8, 2)
    loss_vfm = _masked_mean_l1(vc_pred, targets["v_coor_off"], w_vc)
    # vertex sub-pixel offsets at the gt vertex pixels (rtm3d_loss.py:312-321)
    vo_pred = torch.sigmoid(_gather_pixels(v_off_pred, v_proj))
    loss_voff = _masked_mean_l1(vo_pred, targets["v_off"], w_vc)
    # center sub-pixel offsets (rtm3d_loss.py:323-329)
    mo_pred = torch.sigmoid(_gather_pixels(m_off_pred, m_proj))
    loss_moff = _masked_mean_l1(mo_pred, targets["m_off"], m_valid)

    loss_mkf = loss_mkf * w_mkf
    loss_vfm = loss_vfm * w_vfm
    loss_moff = loss_moff * w_m_off
    loss_voff = loss_voff * w_v_off
    total = loss_mkf + loss_vfm + loss_moff + loss_voff
    aux = torch.stack([loss_mkf, loss_vfm, loss_moff, loss_voff, total]).detach()
    return total, aux
