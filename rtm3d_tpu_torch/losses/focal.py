"""Penalty-reduced focal loss (CenterNet-style).

Port of ``rtm3d_tpu/losses/focal.py:15-50``; reference semantics:
models/nets/module.py:41-68 (FocalLoss) with the ``sigmoid_hm`` clamp of
utils/model_utils.py:10-14. The reference's ``if num_positive == 0``
branch is a ``torch.where``, so the loss never syncs with the host.
"""

from __future__ import annotations

import torch


def sigmoid_hm(logits: torch.Tensor) -> torch.Tensor:
    """sigmoid clamped to [1e-4, 1 - 1e-4] (model_utils.py:10-14)."""
    return torch.clamp(torch.sigmoid(logits), 1e-4, 1 - 1e-4)


def focal_sums(prediction: torch.Tensor, target: torch.Tensor, alpha: float = 2.0,
               beta: float = 4.0, sample_mask: torch.Tensor | None = None):
    """``(pos_sum, neg_sum, num_pos)``, the three sums of the focal loss:
    ``losses/rtm3d_loss.py`` adds them up over the ranks of a process
    group before ``focal_from_sums`` divides.

    prediction: clamped probabilities; target: the same shape, any layout.
    Positive pixels are exactly target == 1 (noise-damped 0.9999 peaks count
    as negatives, module.py:48-49). ``sample_mask``: optional (B,) validity
    over the leading batch axis; rows where it is False add nothing to
    either sum or to the positive count.
    """
    pos = (target == 1.0).to(prediction.dtype)
    neg = (target < 1.0).to(prediction.dtype)
    if sample_mask is not None:
        sm = sample_mask.to(prediction.dtype).reshape((-1,) + (1,) * (prediction.dim() - 1))
        pos = pos * sm
        neg = neg * sm
    neg_weights = torch.pow(1.0 - target, beta)
    pos_loss = torch.log(prediction) * torch.pow(1.0 - prediction, alpha) * pos
    neg_loss = torch.log(1.0 - prediction) * torch.pow(prediction, alpha) * neg_weights * neg
    return pos_loss.sum(), neg_loss.sum(), pos.sum()


def focal_from_sums(pos_sum: torch.Tensor, neg_sum: torch.Tensor, num_pos: torch.Tensor) -> torch.Tensor:
    """The loss from ``focal_sums``'s three sums."""
    return torch.where(num_pos == 0, -neg_sum, -(pos_sum + neg_sum) / torch.clamp(num_pos, min=1.0))
