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

On a band of the frame's rows (the spatial mesh axis, ``rows``): the focal
sums are over the band's pixels, which ``_rank_terms`` adds up over the
world like any rank's pieces; a gather at a centre (``m_proj``) or vertex
(``v_proj``) pixel is taken only by the rank whose band holds the pixel
after the clip to the global map, and the other ranks give that entry
weight 0, so that each object and each vertex counts once in the world's
sums and counts. A vertex often lies in another band than its centre.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from rtm3d_tpu_torch.losses.focal import focal_from_sums, focal_sums, sigmoid_hm
from rtm3d_tpu_torch.parallel.dist import all_reduce_sum, world_size


def _gather_pixels(fmap: torch.Tensor, xy: torch.Tensor, rows=None):
    """fmap (B, C, H, W); xy (B, ..., 2) int -> ((B, ..., C), owned),
    indices clipped. With ``rows`` = (start, stop, height), ``fmap`` holds
    rows [start, stop) of a map of ``height`` rows: ``y`` is clipped to the
    whole map, and ``owned`` (B, ...) says which pixels fall in the band;
    without, ``owned`` is None."""
    B, C, H, W = fmap.shape
    x = xy[..., 0].long().clamp(0, W - 1)
    owned = None
    if rows is None:
        y = xy[..., 1].long().clamp(0, H - 1)
    else:
        start, stop, height = rows
        y = xy[..., 1].long().clamp(0, height - 1)
        owned = (y >= start) & (y < stop)
        y = (y - start).clamp(0, H - 1)
    idx = (y * W + x).reshape(B, 1, -1).expand(B, C, -1)  # (B, C, M)
    out = fmap.reshape(B, C, H * W).gather(2, idx)
    return out.transpose(1, 2).reshape(xy.shape[:-1] + (C,)), owned


def _l1_sums(pred: torch.Tensor, tgt: torch.Tensor, w: torch.Tensor):
    """(sum of |pred - tgt| over the rows where w, every component counted;
    the count of those components)."""
    w = w.to(pred.dtype)
    return (torch.abs(pred - tgt) * w[..., None]).sum(), w.sum() * pred.shape[-1]


def _mean(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den, 0 for an empty selection."""
    return torch.where(den > 0, num / torch.clamp(den, min=1.0), 0.0)


def _rank_terms(focal, l1s):
    """(this rank's share of each term, each term over the global batch),
    over the W ranks of the process group (W = 1 with none).

    One ``all_reduce`` adds up every term's numerator and count. A term's
    value over the global batch is the sum of the numerators over the sum
    of the counts, and the focal term's ``num_pos == 0`` branch is taken
    on the global count. A rank's share is ``W * its numerator / the
    global count``: the mean over the ranks of the shares' gradients
    (what the train step's gradient all-reduce computes) is then the
    gradient of the global-batch loss. The global values are detached.
    With one rank the reduction is the identity and ``W = 1.0``, so each
    share is its term's value, and its gradient, bit for bit (the counts
    carry no gradient)."""
    pos_sum, neg_sum, num_pos = focal
    parts = [pos_sum, neg_sum, num_pos] + [v for pair in l1s for v in pair]
    g = all_reduce_sum(torch.stack([v.detach() for v in parts]))
    n = float(world_size())
    share = [n * focal_from_sums(pos_sum, neg_sum, g[2])]
    value = [focal_from_sums(g[0], g[1], g[2])]
    for i, (num, _) in enumerate(l1s):
        num_g, den_g = g[3 + 2 * i], g[4 + 2 * i]
        share.append(n * _mean(num, den_g))
        value.append(_mean(num_g, den_g))
    return share, value


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
    rows: tuple | None = None,
):
    """logits: NCHW (m_hm_pred, ver_coor_pred, m_off_pred, v_off_pred).

    Returns (loss, aux[5]); aux = [MKF, VFM, M_OFF, V_OFF, total], detached.
    ``sample_mask``: optional (B,) bool; False rows are left out of every
    term's sums and counts, so the result is the loss of the valid rows
    alone (the reference's test_epoch averages true batches, train.py:61-81).

    Under a process group of more than one rank, ``aux`` holds the loss
    of the global batch (every rank's rows), equal on every rank, and
    ``loss`` is this rank's share of it, to differentiate: the mean of
    the ranks' gradients is the global-batch loss's (``_rank_terms``).

    ``rows``: (start, stop, height) when the logits and ``targets['m_hm']``
    hold rows [start, stop) of maps of ``height`` rows (a band of the
    spatial mesh axis); the per-slot targets keep the whole map's pixels.
    """
    m_hm_pred, ver_coor_pred, m_off_pred, v_off_pred = (l.float() for l in logits)
    mask, noise = targets["mask"], targets["noise_mask"]
    m_proj, v_proj, v_mask = targets["m_proj"], targets["v_proj"], targets["v_mask"]

    # main keypoint focal (rtm3d_loss.py:285)
    focal = focal_sums(sigmoid_hm(m_hm_pred), targets["m_hm"], focal_alpha, focal_beta, sample_mask=sample_mask)

    ofm_valid = mask & ~noise & targets["mask_3d"]  # (B, N) (rtm3d_loss.py:300)
    m_valid = mask & ~noise
    if sample_mask is not None:
        ofm_valid = ofm_valid & sample_mask[:, None]
        m_valid = m_valid & sample_mask[:, None]
    w_vc = ofm_valid[..., None] & v_mask  # (B, N, 8)

    # vertex-from-center coordinates at the gt centers, raw (rtm3d_loss.py:303-310)
    B, N = m_proj.shape[:2]
    vc_pred, m_owned = _gather_pixels(ver_coor_pred, m_proj, rows)
    vc_pred = vc_pred.reshape(B, N, 8, 2)
    # vertex sub-pixel offsets at the gt vertex pixels (rtm3d_loss.py:312-321)
    vo_pred, v_owned = _gather_pixels(v_off_pred, v_proj, rows)
    vo_pred = torch.sigmoid(vo_pred)
    # center sub-pixel offsets (rtm3d_loss.py:323-329)
    mo_pred = torch.sigmoid(_gather_pixels(m_off_pred, m_proj, rows)[0])
    w_vo = w_vc
    if rows is not None:  # each centre and vertex counted by the band that holds it
        w_vo = w_vc & v_owned
        w_vc = w_vc & m_owned[..., None]
        m_valid = m_valid & m_owned
    l1s = [_l1_sums(vc_pred, targets["v_coor_off"], w_vc), _l1_sums(mo_pred, targets["m_off"], m_valid),
           _l1_sums(vo_pred, targets["v_off"], w_vo)]

    weights = (w_mkf, w_vfm, w_m_off, w_v_off)
    share, value = _rank_terms(focal, l1s)
    terms = [w * t for w, t in zip(weights, value)]
    return sum(w * t for w, t in zip(weights, share)), torch.stack(terms + [sum(terms)]).detach()
