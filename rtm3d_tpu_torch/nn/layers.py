"""Shared building blocks with reference-parity initialisation.

Port of ``rtm3d_tpu/nn/layers.py``: ``Conv``, ``ConvBNReLU``, ``ConvLevel``
and ``UpSample`` (its ``MaxPool`` is ``nn.MaxPool2d``), laid out as the
reference's torch modules so that a state_dict carries the reference names
(a ``ConvLevel`` is one flat ``nn.Sequential`` of conv/BN/ReLU triples,
``torch_utils.make_conv_level``).

Init parity with ``rtm3d_tpu/nn/layers.py:27-33`` and ``:428-449``:
xavier-uniform conv kernels, torch's conv bias init U(+-1/sqrt(fan_in)),
transposed-conv kernels U(+-sqrt(3/(out*k*k))) with the bilinear fill of
output channel 0 only; BatchNorm eps 1e-4, momentum 0.03. ``init_weights``
applies it from a ``torch.Generator``.

Not ported, because none of it is on the inference path: the space-to-depth
stem (train-only in the JAX package), the phase-decomposed upsample (off by
default there), ``stop_bias_grad`` and the ``_upsample2x`` custom VJP (both
training-gradient tricks). The port runs the plain convolution each of them
reparameterises.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

BN_EPS = 1e-4
BN_MOMENTUM = 0.03  # torch convention; flax momentum 0.97


class Conv(nn.Conv2d):
    """2D conv with torch-style symmetric padding ``dilation*(k-1)//2``."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        stride: int = 1,
        dilation: int = 1,
        bias: bool = False,
        padding: int | None = None,
    ):
        if padding is None:
            padding = dilation * (kernel_size - 1) // 2
        super().__init__(
            in_channels, out_channels, kernel_size, stride, padding,
            dilation=dilation, bias=bias,
        )

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        k = self.kernel_size[0] * self.kernel_size[1]
        fan_in, fan_out = self.in_channels * k, self.out_channels * k
        bound = math.sqrt(6.0 / (fan_in + fan_out))  # xavier-uniform
        self.weight.uniform_(-bound, bound, generator=generator)
        if self.bias is not None:
            b = 1.0 / math.sqrt(fan_in)
            self.bias.uniform_(-b, b, generator=generator)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm with the reference's eps/momentum (torch_utils.py:79-81)."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS, momentum=BN_MOMENTUM)


class ConvBNReLU(nn.Sequential):
    """conv -> BN -> ReLU as indices 0, 1, 2."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        stride: int = 1,
        dilation: int = 1,
        bias: bool = False,
    ):
        super().__init__(
            Conv(in_channels, out_channels, kernel_size, stride, dilation, bias),
            BatchNorm(out_channels),
            nn.ReLU(inplace=True),
        )


class ConvLevel(nn.Sequential):
    """The reference's ``make_conv_level`` (utils/torch_utils.py:179-204):
    ``num_convs`` x (conv-BN-ReLU) flattened into one Sequential (conv I at
    index 3I, its BN at 3I+1), stride on the first conv only, per-layer
    dilation. Intermediate convs keep ``in_channels``; only the last maps to
    ``out_channels`` (torch_utils.py:188)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        num_convs: int = 1,
        stride: int = 1,
        dilation=1,
        bias: bool = False,
    ):
        dil = [dilation] * num_convs if isinstance(dilation, int) else list(dilation)
        chans = [in_channels] * (num_convs - 1) + [out_channels]
        mods = []
        cin = in_channels
        for i in range(num_convs):
            mods.extend(
                ConvBNReLU(cin, chans[i], kernel_size, stride if i == 0 else 1, dil[i], bias)
            )
            cin = chans[i]
        super().__init__(*mods)


def bilinear_kernel_1d(k: int) -> np.ndarray:
    """The reference's separable bilinear fill (utils/torch_utils.py:53-68)."""
    f = math.ceil(k / 2)
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    return np.array([1 - abs(i / f - c) for i in range(k)], dtype=np.float32)


class UpSample(nn.Module):
    """Learned 2x upsampling: ConvTranspose(k=2*factor, s=factor,
    p=factor/2), no bias (reference: models/nets/module.py:7-15)."""

    def __init__(self, channels: int, factor: int = 2):
        super().__init__()
        self.conv_tran = nn.ConvTranspose2d(
            channels, channels, 2 * factor, stride=factor, padding=factor // 2, bias=False
        )

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        w = self.conv_tran.weight  # (in, out, kh, kw)
        _, out_ch, kh, kw = w.shape
        bound = math.sqrt(1.0 / (out_ch * kh * kw)) * math.sqrt(3.0)
        w.uniform_(-bound, bound, generator=generator)
        b1 = bilinear_kernel_1d(kh)
        # the reference fills out-channel 0 only, for every in-channel
        w[:, 0] = torch.as_tensor(np.outer(b1, b1), dtype=w.dtype)

    def forward(self, x):
        return self.conv_tran(x)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Apply the reference-parity init to every conv and upsample of
    ``model``, in module order, drawing from ``generator``."""
    for m in model.modules():
        if isinstance(m, (Conv, UpSample)):
            m.reset_parameters(generator)
    return model
