"""The reference's training semantics, for the torch twin.

The port's copy of ``tests/test_train_parity.py::_torch_loss`` (:37-82)
and ``_torch_optimizer`` (:85-108), the reference leg of the side-by-side
mode of ``tools/ap_parity.py``:

- ``reference_loss``: the reference's loss (models/rtm3d_loss.py:268-340)
  in its dynamic form: boolean gathers of the predictions at the
  ground-truth pixels, ``F.l1_loss`` over what they select, the focal term
  over the heatmap, weights (1, 1, 0.5, 0.5) for MKF, VFM, M_OFF and
  V_OFF. The gathers' sizes depend on the labels, so a call waits for the
  device.
- ``reference_optimizer``: the reference's parameter groups
  (solver/OptimizerBuilder.py:13-36) over ``torch.optim.Adamax``: weights,
  biases (lr x BIAS_LR_FACTOR) and norm parameters, each with its weight
  decay; every BatchNorm parameter is a norm parameter (the reference
  tests the attribute name, which misses the trunk's ``bn*``).

The module is independent of the port's ``losses/`` and ``train/optim.py``
on purpose: the side-by-side mode holds those modules, through the port's
train step, against this one. The only change from the copied test
helpers is the device: the batch index is made on the targets' device,
so the loss runs on the card as on the host. Targets come in the JAX
package's layout: ``m_hm`` (B, H, W, C), the other keys as
``data/targets.py::build_targets`` returns them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

LOSS_WEIGHTS = (1.0, 1.0, 0.5, 0.5)  # MKF, VFM, M_OFF, V_OFF


def reference_loss(logits_nchw, t, w=LOSS_WEIGHTS) -> torch.Tensor:
    """The total loss of the 4 NCHW logit maps against the targets ``t``."""
    m_hm_pred, vc_pred, mo_pred, vo_pred = (x.permute(0, 2, 3, 1) for x in logits_nchw)
    pred = torch.clamp(torch.sigmoid(m_hm_pred), 1e-4, 1 - 1e-4)
    tgt = t["m_hm"]
    pos = tgt.eq(1).float()
    neg = tgt.lt(1).float()
    pl = torch.log(pred) * torch.pow(1 - pred, 2.0) * pos
    nl = torch.log(1 - pred) * torch.pow(pred, 2.0) * torch.pow(1 - tgt, 4.0) * neg
    npos = pos.sum()
    l_mkf = -nl.sum() if npos == 0 else -(pl.sum() + nl.sum()) / npos

    ofm_valid = t["mask"] & ~t["noise_mask"] & t["mask_3d"]
    Bt, Nt = t["mask"].shape
    bidx = torch.arange(Bt, device=t["mask"].device)[:, None].expand(Bt, Nt)
    sel = ofm_valid
    mp = t["m_proj"][sel]
    vc = vc_pred[bidx[sel], mp[:, 1], mp[:, 0]].reshape(-1, 8, 2)
    exp = t["v_mask"][sel]
    l_vfm = F.l1_loss(vc[exp], t["v_coor_off"][sel][exp]) if exp.any() else vc.sum() * 0.0
    bidx8 = bidx[..., None].expand(Bt, Nt, 8)
    vsel = ofm_valid[..., None].expand(Bt, Nt, 8) & t["v_mask"]
    vp = t["v_proj"][vsel]
    vo = torch.sigmoid(vo_pred[bidx8[vsel], vp[:, 1], vp[:, 0]])
    l_voff = F.l1_loss(vo, t["v_off"][vsel]) if vsel.any() else vo_pred.sum() * 0.0
    msel = t["mask"] & ~t["noise_mask"]
    mp2 = t["m_proj"][msel]
    mo = torch.sigmoid(mo_pred[bidx[msel], mp2[:, 1], mp2[:, 0]])
    l_moff = F.l1_loss(mo, t["m_off"][msel]) if msel.any() else mo_pred.sum() * 0.0
    return w[0] * l_mkf + w[1] * l_vfm + w[2] * l_moff + w[3] * l_voff


def reference_optimizer(twin, lr, wd, wd_bias, wd_norm, bias_lr_factor) -> torch.optim.Adamax:
    """Adamax over three groups of ``twin``'s parameters: weights (lr,
    ``wd``), biases (lr x ``bias_lr_factor``, ``wd_bias``) and every
    BatchNorm parameter (lr, ``wd_norm``); coupled weight decay."""
    norm_params = set()
    for mod in twin.modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            norm_params.update(id(p) for p in mod.parameters(recurse=False))
    groups = {"weight": [], "bias": [], "norm": []}
    for name, p in twin.named_parameters():
        if id(p) in norm_params:
            groups["norm"].append(p)
        elif name.endswith(".bias"):
            groups["bias"].append(p)
        else:
            groups["weight"].append(p)
    return torch.optim.Adamax(
        [
            {"params": groups["weight"], "lr": lr, "weight_decay": wd},
            {"params": groups["bias"], "lr": lr * bias_lr_factor, "weight_decay": wd_bias},
            {"params": groups["norm"], "lr": lr, "weight_decay": wd_norm},
        ],
        lr=lr,
    )


def to_reference_targets(targets: dict) -> dict:
    """The port's targets (``build_targets``: ``m_hm`` NCHW) in the layout
    ``reference_loss`` reads (``m_hm`` NHWC, as the JAX package builds it)."""
    return {**targets, "m_hm": targets["m_hm"].permute(0, 2, 3, 1)}
