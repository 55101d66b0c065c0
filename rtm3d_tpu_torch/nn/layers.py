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

Training semantics carried over from the JAX package:
- ``stop_bias_grad`` (``rtm3d_tpu/nn/layers.py:93-117``, switched on for
  every conv of a ``ConvBNReLU`` in train mode at ``:173``; the header's
  fused first conv does the same, ``header.py:100-102``) is semantics, not
  a layout trick: a conv bias that feeds train-mode BatchNorm gets a
  gradient of exactly 0 there, so with coupled weight decay its update is
  driven by ``wd * p`` alone. In PyTorch the same gradient is 0 only up to
  rounding noise, which Adamax (dividing by ``|g| + eps``) would turn into
  lr-sized steps. So a ``Conv`` built with ``stop_bias_grad`` uses
  ``bias.detach()`` in train mode; the train step fills such gradients
  with exact zeros. In the DLA-34 model these are the header's
  ``ConvLevel`` convs, the only ones with ``bias=True`` before a BN.
- BN running variance: flax folds the *biased* batch variance into
  ``running_var`` (``ra = m*ra + (1-m)*var``), where ``nn.BatchNorm2d``
  folds the unbiased one (a factor n/(n-1)). ``BatchNorm`` corrects
  torch's update so the running statistics follow flax's. Normalisation
  itself uses the biased variance in both.

Rematerialisation (``TPU.REMAT``, ``rtm3d_tpu/train/step.py:141-142``):
``remat_segment`` runs a segment of the network under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, which
drops the segment's activations after the forward and recomputes them in
the backward. ``jax.checkpoint`` recomputes a pure function; here the
recompute would run every train-mode ``BatchNorm`` of the segment again,
which would count ``num_batches_tracked`` and fold the batch into the
running statistics a second time. So the checkpoint's ``context_fn``
(``_bn_guard``) marks the first pass and the recompute: on the recompute
a ``BatchNorm`` counts nothing and folds nothing (its output in train mode
does not depend on the running statistics, so the local path normalises
with throw-away copies of them), and the synchronised path takes the
mean, variance and count the first pass stashed, so that its output is
the first pass's bit for bit (recomputed, its shift, the running mean,
would be the updated one, and the statistics would differ in their last
bits) and it issues no all-reduce again. The backward all-reduce runs
once, in the first pass's node.

The spatial mesh axis (``parallel/spatial.py``): while a ``Grid`` is
attached to the model (its ``spatial`` attribute), ``Conv``, ``UpSample``
and ``MaxPool`` run on this rank's band of the frame's rows. ``Conv`` and
``MaxPool`` take ``halo_rows`` rows of the neighbouring bands
(``halo_exchange``, with 0 or -inf at the frame's edges) and then run with
no padding in H and their own in W; ``UpSample`` takes one row from each
side and crops its output band. Under autocast a float32 input is cast to
autocast's dtype before the exchange, as the convolution would cast it
(the same numbers, half the bytes). 1x1 convs exchange nothing. BatchNorm
needs no change: its synchronised sums already run over every rank, and
the ranks' (frame, band) pieces are disjoint, so ``n`` is the band's
pixel count and the sums are the global batch's. With no grid, every op
runs the path it always ran.

Not ported, being exact reparameterisations of the plain convolution the
port runs: the space-to-depth stem (train-only in the JAX package), the
phase-decomposed upsample (off by default there) and the ``_upsample2x``
custom VJP.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from rtm3d_tpu_torch.parallel.dist import all_reduce_sum, world_size
from rtm3d_tpu_torch.parallel.spatial import halo_exchange, halo_rows

BN_EPS = 1e-4
BN_MOMENTUM = 0.03  # torch convention; flax momentum 0.97


def kernel_may_run(x: torch.Tensor) -> bool:
    """The conditions on how the forward runs under which a layer takes its
    hand-written inference kernel (the KFPN fusion, the deformable conv): a
    CUDA input, no autograd recording, no autocast, no ``torch.compile`` or
    ``torch.export`` trace."""
    return (x.device.type == "cuda" and not torch.is_grad_enabled()
            and not torch.is_autocast_enabled(x.device.type) and not torch.compiler.is_compiling())


def autocast_input(x: torch.Tensor) -> torch.Tensor:
    """``x`` cast as autocast casts a convolution's input (to its dtype,
    when autocast is on for ``x``'s device and ``x`` is float32), so that a
    halo is exchanged at the width the convolution reads it; else ``x``."""
    kind = x.device.type
    if x.dtype == torch.float32 and torch.is_autocast_enabled(kind):
        return x.to(torch.get_autocast_dtype(kind))
    return x


class Conv(nn.Conv2d):
    """2D conv with torch-style symmetric padding ``dilation*(k-1)//2``.
    ``stop_bias_grad``: in train mode the bias gets no gradient (it feeds
    BatchNorm; see the module docstring). ``spatial``: the grid of the
    band this conv runs on (see the module docstring), or None;
    ``haloed_input``: on a band, the input arrives with this conv's halo
    rows already exchanged (the header's four branches share one
    exchange, ``nn/header.py``)."""

    spatial = None
    haloed_input = False

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        stride: int = 1,
        dilation: int = 1,
        bias: bool = False,
        padding: int | None = None,
        stop_bias_grad: bool = False,
    ):
        if padding is None:
            padding = dilation * (kernel_size - 1) // 2
        super().__init__(
            in_channels, out_channels, kernel_size, stride, padding,
            dilation=dilation, bias=bias,
        )
        self.stop_bias_grad = stop_bias_grad

    def forward(self, x):
        if self.spatial is not None:
            return self._banded(x)
        if self.training and self.stop_bias_grad and self.bias is not None:
            return self._conv_forward(x, self.weight, self.bias.detach())
        return super().forward(x)

    def _banded(self, x):
        bias = self.bias
        if self.training and self.stop_bias_grad and bias is not None:
            bias = bias.detach()
        if not self.haloed_input:
            x = halo_exchange(autocast_input(x), *self.halo(), 0.0, self.spatial)
        return F.conv2d(x, self.weight, bias, self.stride, (0, self.padding[1]), self.dilation, self.groups)

    def halo(self) -> tuple:
        """``(top, bottom)`` rows this conv reads beyond its band."""
        return halo_rows(self.kernel_size[0], self.stride[0], self.dilation[0], self.padding[0])

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        k = self.kernel_size[0] * self.kernel_size[1]
        fan_in, fan_out = self.in_channels * k, self.out_channels * k
        bound = math.sqrt(6.0 / (fan_in + fan_out))  # xavier-uniform
        self.weight.uniform_(-bound, bound, generator=generator)
        if self.bias is not None:
            b = 1.0 / math.sqrt(fan_in)
            self.bias.uniform_(-b, b, generator=generator)


@contextlib.contextmanager
def _remat_mode(bns: list, mode: str):
    """Each of ``bns`` in ``mode`` (``"record"``: the segment's first pass;
    ``"replay"``: its recompute) for the block."""
    for bn in bns:
        bn.remat_mode = mode
    try:
        yield
    finally:
        for bn in bns:
            bn.remat_mode = None


def _bn_guard(module: nn.Module):
    """The ``context_fn`` of ``remat_segment`` over ``module``: its
    BatchNorms record on the first pass and replay on the recompute (see
    the module docstring)."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for bn in bns:
        bn.remat_stash.clear()
    return _remat_mode(bns, "record"), _remat_mode(bns, "replay")


def remat_segment(module: nn.Module, remat: bool, *args):
    """``module(*args)``; with ``remat``, in train mode and with gradients
    on, under a non-reentrant ``torch.utils.checkpoint`` whose recompute
    leaves the BatchNorms' running statistics alone (``_bn_guard``). The
    network draws no random numbers, so no RNG state is kept."""
    if remat and module.training and torch.is_grad_enabled():
        return checkpoint(module, *args, use_reentrant=False, preserve_rng_state=False,
                          context_fn=functools.partial(_bn_guard, module))
    return module(*args)


class _SyncBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the rows of every rank: the JAX step under
    a ``data`` mesh takes flax's batch statistics over the global batch.

    Forward: one ``all_reduce`` of ``[sum(x - K), sum((x - K)^2), n]`` per
    channel, from this rank's ``torch.var_mean`` (one pass over ``x``),
    in float64; from it the global mean and the biased variance, and the
    running statistics folded as flax folds them (``BatchNorm``). ``K`` is
    the running mean, equal on every rank: a shift that keeps the
    subtraction ``E[(x-K)^2] - E[x-K]^2`` from cancelling when a channel's
    mean is large against its spread. float64 keeps the count exact past
    2^24 values. Backward: one ``all_reduce`` of ``[sum(dy), sum(dy *
    x_hat)]``, and the input gradient of BatchNorm over the global batch;
    the weight and bias gradients are this rank's sums, which the train
    step's gradient all-reduce adds up. Statistics in the running
    statistics' dtype (float32, float64 in the reduction) whatever ``x``'s
    dtype (bfloat16 under autocast); the output in ``x``'s dtype."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum: float, eps: float,
                remat_mode=None, remat_stash=None):
        if remat_mode == "replay":  # a checkpoint's recompute: the first pass's statistics, folded then
            mean, var, total = remat_stash.popleft()
        else:
            C = x.shape[1]
            n = x.numel() // C
            sdt = running_mean.dtype  # the statistics' dtype: float32, or float64 for a float64 module
            shift = running_mean.detach().double()
            var_l, mean_l = torch.var_mean(x.to(sdt), dim=(0, 2, 3), correction=0)
            d_l = mean_l.double() - shift
            stats = torch.cat([n * d_l, n * (var_l.double() + d_l * d_l), d_l.new_full((1,), float(n))])
            stats = all_reduce_sum(stats)
            total = stats[-1]
            d = stats[:C] / total
            mean = (shift + d).to(sdt)
            var = (stats[C:2 * C] / total - d * d).clamp_(min=0.0).to(sdt)
            with torch.no_grad():
                running_mean.mul_(1 - momentum).add_(mean, alpha=momentum)
                running_var.mul_(1 - momentum).add_(var, alpha=momentum)
            if remat_mode == "record":
                remat_stash.append((mean, var, total))
        invstd = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.total = total
        return F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd = ctx.saved_tensors
        C = x.shape[1]
        dyf = dy.to(mean.dtype)
        xhat = (x.to(mean.dtype) - mean[:, None, None]) * invstd[:, None, None]
        sums = torch.cat([dyf.sum((0, 2, 3)), (dyf * xhat).sum((0, 2, 3))])
        dbias, dweight = sums[:C].clone(), sums[C:].clone()
        sums = all_reduce_sum(sums)
        scale = (weight * invstd)[:, None, None]
        total = ctx.total.to(mean.dtype)
        dx = scale * (dyf - sums[:C, None, None] / total - xhat * (sums[C:, None, None] / total))
        return dx.to(x.dtype), dweight, dbias, None, None, None, None, None, None


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm with the reference's eps/momentum (torch_utils.py:79-81);
    in train mode ``running_var`` follows the biased batch variance, as
    flax's does. In train mode under a process group of more than one rank
    the statistics are the global batch's (``_SyncBatchNorm``); with one
    rank, or none, the path below is the one it always was. In the
    recompute of a checkpointed segment (``remat_segment``) it counts and
    folds nothing."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.remat_mode = None  # "record" or "replay" inside a checkpointed segment (_bn_guard)
        self.remat_stash = collections.deque()  # the synchronised statistics the first pass keeps

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        self._check_input_dim(x)
        replay = self.remat_mode == "replay"
        if not replay:
            self.num_batches_tracked.add_(1)
        if world_size() > 1:
            return _SyncBatchNorm.apply(x, self.weight, self.bias, self.running_mean, self.running_var,
                                        self.momentum, self.eps, self.remat_mode, self.remat_stash)
        if replay:  # the batch's statistics, as on the first pass; throw-away running statistics
            return F.batch_norm(x, self.running_mean.clone(), self.running_var.clone(), self.weight, self.bias,
                                True, self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        # torch folds the unbiased batch variance into the copy it is given
        # (autograd saves that copy, so it is not touched again):
        #   torch = (1-m) old + m var n/(n-1);  flax = (1-m) old + m var
        #   flax = torch (n-1)/n + (1-m) old / n
        folded = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, folded, self.weight, self.bias,
                         True, self.momentum, self.eps)
        with torch.no_grad():
            self.running_var.copy_(folded * ((n - 1) / n) + self.running_var * ((1 - self.momentum) / n))
        return y


class ConvBNReLU(nn.Sequential):
    """conv -> BN -> ReLU as indices 0, 1, 2; the conv's bias, if any, takes
    no gradient in train mode (``stop_bias_grad``)."""

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
            Conv(in_channels, out_channels, kernel_size, stride, dilation, bias, stop_bias_grad=True),
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
    p=factor/2), no bias (reference: models/nets/module.py:7-15). On a
    band (``spatial``), output rows ``[f*a, f*b)`` read input rows ``a - 1``
    to ``b``: one halo row each side, no padding in H, and the band cropped
    from the output (the first ``f + p`` rows are the halo's)."""

    spatial = None

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
        if self.spatial is None:
            return self.conv_tran(x)
        t = self.conv_tran
        f, p, h = t.stride[0], t.padding[0], x.shape[2]
        x = halo_exchange(autocast_input(x), 1, 1, 0.0, self.spatial)
        y = F.conv_transpose2d(x, t.weight, t.bias, t.stride, (0, t.padding[1]), 0, t.groups, t.dilation)
        return y[:, :, f + p:f + p + f * h]


class MaxPool(nn.MaxPool2d):
    """``nn.MaxPool2d`` (its padding is -inf); on a band (``spatial``) the
    halo rows of ``halo_rows``, -inf at the frame's edges."""

    spatial = None

    def forward(self, x):
        if self.spatial is None:
            return super().forward(x)
        k, s, p = self.kernel_size, self.stride, self.padding
        top, bottom = halo_rows(k, s, self.dilation, p)
        x = halo_exchange(x, top, bottom, float("-inf"), self.spatial)
        return F.max_pool2d(x, k, s, (0, p), self.dilation, self.ceil_mode)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Apply the reference-parity init to every conv and upsample of
    ``model``, in module order, drawing from ``generator``."""
    for m in model.modules():
        if isinstance(m, (Conv, UpSample)):
            m.reset_parameters(generator)
    return model
