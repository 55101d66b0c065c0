"""Keypoint FPN fusion.

Port of ``rtm3d_tpu/nn/kfpn.py:28-69``; reference semantics:
models/nets/keypoint_fpn_fusion.py:18-69.
(a) top-down FPN: for each level high->low, 1x1 ``head`` to OUT_CHANNELS,
learned transposed-conv 2x upsample, concat with the next-lower feature, 1x1
``proj`` back to that level's channel count;
(b) fusion: every level's OUT_CHANNELS output is chained-upsampled to the
lowest stride, then accumulated with a *detached* per-channel spatial softmax
weight (``z += up(out_i) * softmax_HW(up(out_i).detach())``, kfpn:62-68).

On a band of the frame's rows (the spatial mesh axis, ``spatial`` set by
``parallel/spatial.py::attached``) the softmax is still over the whole
frame's H x W: ``spatial.softmax_hw`` takes each channel's max and its sum
of exponentials over every band. A band-local softmax would run, give
finite numbers, and be wrong.

The fusion takes one of two paths, chosen from what the forward observes:
- fused: ``ops/kfpn_fuse.py::kfpn_fuse``, the hand-written kernel's two
  launches (every map's per-channel statistics, then the weighted sum,
  accumulated in float32 and rounded once), where the maps are CUDA
  tensors, autograd is not recording (the detect step runs under
  ``inference_mode``), autocast is off, no grid is attached and no
  ``torch.compile`` or ``torch.export`` trace is running. That is the
  detect step, the ``Detector``, int8 serving and its calibration. Maps
  the kernel does not take (NCHW, C not a multiple of 8, mixed dtypes)
  raise there: there is no second inference path on the card;
- composed, the loop below, everywhere else: training and the eval-loss
  step under autocast (the softmax in float32, and autograd keeps each
  weight for the backward), spatial bands (``softmax_hw`` across ranks),
  export, and the CPU.
The two are kept apart, not one adapted to both: training needs the
backward and autocast's float32 softmax, a different algorithm, so they
share no code; the CPU tests hold the plain version of the kernel
(``kfpn_fuse_reference``) to the composed loop.
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

import torch
from torch import nn

from rtm3d_tpu_torch.nn.layers import Conv, UpSample, kernel_may_run
from rtm3d_tpu_torch.nn.spec import ShapeSpec
from rtm3d_tpu_torch.ops.kfpn_fuse import kfpn_fuse
from rtm3d_tpu_torch.parallel.spatial import softmax_hw
from rtm3d_tpu_torch.utils.profiling import count


class KeypointFPNFusion(nn.Module):
    spatial = None  # the grid of this rank's band (parallel/spatial.py), or None

    def __init__(
        self,
        kfns: Sequence[str],
        kfpn_spec: Mapping[str, ShapeSpec],
        out_channels: int = 256,
    ):
        super().__init__()
        strides = [kfpn_spec[k].stride for k in kfns]
        channels = [kfpn_spec[k].channels for k in kfns]
        if any(strides[i] != 2 * strides[i - 1] for i in range(1, len(strides))):
            raise ValueError(f"KFPN levels must double in stride: {strides}")
        self.levels = [int(math.log2(s)) for s in strides]
        lv = self.levels
        for i in range(len(lv) - 1, 0, -1):
            self.add_module(f"kfpn_head{lv[i]}", Conv(channels[i], out_channels, 1, bias=True, padding=0))
            self.add_module(f"kfpn_up{lv[i]}", UpSample(out_channels))
            self.add_module(
                f"kfpn_proj{lv[i]}",
                Conv(out_channels + channels[i - 1], channels[i - 1], 1, bias=True, padding=0),
            )
        self.add_module(f"kfpn_head{lv[0]}", Conv(channels[0], out_channels, 1, bias=True, padding=0))
        for i in range(len(lv) - 1, 0, -1):
            self.add_module(
                f"fusion_up{lv[i]}",
                nn.Sequential(*[UpSample(out_channels) for _ in range(lv[i] - lv[0])]),
            )

    def forward(self, feats):
        lv = self.levels
        n = len(lv)
        if len(feats) != n:
            raise ValueError(f"expected {n} feature maps, got {len(feats)}")
        x = list(feats)
        # top-down pathway (kfpn:35-46)
        for i in range(n - 1, 0, -1):
            x[i] = getattr(self, f"kfpn_head{lv[i]}")(x[i])
            up = getattr(self, f"kfpn_up{lv[i]}")(x[i])
            x[i - 1] = getattr(self, f"kfpn_proj{lv[i]}")(torch.cat([up, x[i - 1]], 1))
        x[0] = getattr(self, f"kfpn_head{lv[0]}")(x[0])

        # softmax-attention fusion at the lowest stride (kfpn:62-68)
        ups = (getattr(self, f"fusion_up{lv[i]}")(x[i]) for i in range(n - 1, 0, -1))
        if self.spatial is None and kernel_may_run(x[0]):
            z = kfpn_fuse(x[0], list(ups))
            count("kfpn_fused")
            return z
        z = x[0]
        for out_i in ups:
            b, c, h, w = out_i.shape
            # softmax over H*W per channel, as a last-dim softmax of a
            # (B, C, H*W) copy: PyTorch's softmax over the middle dim of the
            # free (B, H*W, C) view of a channels_last map took 113 ms of a
            # 358 ms b128 call on an H100 (chip_smoke.py's profile phase)
            flat = out_i.detach().reshape(b, c, h * w)
            if self.spatial is None:
                att = torch.softmax(flat, dim=-1).reshape(b, c, h, w)
            else:
                att = softmax_hw(flat, self.spatial).reshape(b, c, h, w)
            z = z + out_i * att
        return z
