"""Modulated deformable convolution (DCNv2, Zhu et al., arXiv:1811.11168) in
plain ``torch.nn``, as mmcv's ``ModulatedDeformConv2dPack`` computes it for
FCOS3D's ResNet-101-DCN: a 3x3 conv, stride 1, padding 1, one deformable
group, no bias, whose nine taps are sampled at learned offsets and weighted
by a learned mask.

``conv_offset`` (``nn.Conv2d(C, 27, 3, padding=1)``, with bias) gives each
output pixel's (dy_k, dx_k) for tap k = 3i + j at channels (2k, 2k + 1),
then 9 mask logits (channels 18..26) that pass through a sigmoid. Each tap
is sampled with ``F.grid_sample`` (bilinear, ``align_corners=True``, zero
padding: a corner outside the map reads 0, so a position outside
(-1, H) x (-1, W) reads 0, as mmcv's sampler does), multiplied by its mask,
and laid out as a (3H, 3W) tap image (pixel (3h + i, 3w + j) is tap k of
output pixel (h, w)), to which the child ``conv``, ``nn.Conv2d(C, C_out, 3,
stride=3, bias=False)``, applies the 3x3 weight. So the benchmark's seeded
draw gives ``conv`` a 3x3 conv's xavier bound, the float8 control
(``layers.lower_precision``) rounds the sampled taps and the weights as it
rounds every conv's input and weights, and ``FlopCounterMode`` counts the
layer's 2 x 9 x C_in x C_out x H x W operations (``grid_sample`` counts none).
Maps of one row or one column are not taken (``align_corners`` normalises
by H - 1 and W - 1).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F


class ModulatedDeformConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv_offset = nn.Conv2d(cin, 27, 3, 1, 1, bias=True)
        self.conv = nn.Conv2d(cin, cout, 3, stride=3, bias=False)

    def forward(self, x):
        B, C, H, W = x.shape
        om = self.conv_offset(x)
        mask = torch.sigmoid(om[:, 18:27])
        ys = torch.arange(H, dtype=x.dtype, device=x.device).view(1, 1, 1, H, 1)
        xs = torch.arange(W, dtype=x.dtype, device=x.device).view(1, 1, 1, 1, W)
        rows = torch.arange(-1, 2, dtype=x.dtype, device=x.device)
        taps = []
        for i in range(3):
            for j in range(3):
                k = 3 * i + j
                py = ys + rows[i] + om[:, 2 * k].view(B, 1, 1, H, W)
                px = xs + rows[j] + om[:, 2 * k + 1].view(B, 1, 1, H, W)
                grid = torch.stack([px * (2.0 / (W - 1)) - 1.0, py * (2.0 / (H - 1)) - 1.0], -1).view(B, H, W, 2)
                s = F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros", align_corners=True)
                taps.append(s * mask[:, k:k + 1])
        t = torch.stack(taps, 2).view(B, C, 3, 3, H, W)  # (b, c, i, j, h, w)
        return self.conv(t.permute(0, 1, 4, 2, 5, 3).reshape(B, C, 3 * H, 3 * W))
