"""Shared pieces of the reference networks, and the lower-precision control.

``make_conv_level`` is the reference's ``torch_utils.make_conv_level``
(utils/torch_utils.py:179-204). ``lower_precision`` turns a reference
network into the control of ``correct``: every convolution and transposed
convolution reads its input and its weights rounded to float8 e4m3 (one
scale a tensor, the weights one a output channel) and accumulates in
float32, as an fp8 tensor-core path would; the gradient passes the rounding
straight through. That is the nearest precision below the bfloat16 the
configurations state.
"""

import types

import torch
import torch.nn as nn
import torch.nn.functional as F

EPS = 1e-4  # BatchNorm eps of the reference's initialize_weights (torch_utils.py:79-81)
FP8_MAX = 448.0  # the largest finite float8 e4m3fn


def make_conv_level(cin, cout, k, num, bias=False, dilation=1):
    if isinstance(dilation, int):
        dilation = [dilation] * num
    chans = [cin] * (num - 1) + [cout]
    mods = []
    c = cin
    for i in range(num):
        mods += [
            nn.Conv2d(c, chans[i], k, 1, (k - 1) * dilation[i] // 2, dilation=dilation[i], bias=bias),
            nn.BatchNorm2d(chans[i], eps=EPS),
            nn.ReLU(inplace=True),
        ]
        c = chans[i]
    return nn.Sequential(*mods)


def fp8_round(x: torch.Tensor, dims=None) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a scale that maps its largest
    magnitude (over ``dims``, all when None) to 448; float32 out, the
    gradient straight through."""
    amax = x.detach().abs().amax() if dims is None else x.detach().abs().amax(dim=dims, keepdim=True)
    scale = amax.clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


def _fp8_conv(self, x):
    w = fp8_round(self.weight, dims=(1, 2, 3))
    return F.conv2d(fp8_round(x), w, self.bias, self.stride, self.padding, self.dilation, self.groups)


def _fp8_conv_transpose(self, x):
    w = fp8_round(self.weight)
    return F.conv_transpose2d(fp8_round(x), w, self.bias, self.stride, self.padding, self.output_padding,
                              self.groups, self.dilation)


def lower_precision(net: nn.Module) -> nn.Module:
    """``net`` with every convolution computed from float8 inputs and
    weights (in place; returns ``net``)."""
    for m in net.modules():
        if isinstance(m, nn.ConvTranspose2d):
            m.forward = types.MethodType(_fp8_conv_transpose, m)
        elif isinstance(m, nn.Conv2d):
            m.forward = types.MethodType(_fp8_conv, m)
    return net
