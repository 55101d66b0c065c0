"""Modulated deformable convolution (DCNv2): CUDA kernel wrapper and plain version.

    y[b, o, h, w] = sum_k sum_c W[o, c, i, j] * m_k * bilinear(x[b, c], p + p_k + dp_k)

for the 3x3 taps k = 3i + j at p_k = (i - 1, j - 1) about the output pixel
p = (h, w): stride 1, padding 1, dilation 1, one deformable group, no bias
(Zhu et al., arXiv:1811.11168; mmcv's ``ModulatedDeformConv2dPack``). ``om``
is the offset conv's raw output, 27 channels: (dy_k, dx_k) at channels
(2k, 2k + 1) for k = 0..8, then the 9 mask logits, which pass through a
sigmoid. A sample reads 0 where its position lies outside (-1, H) x (-1, W),
and each of its four bilinear corners that falls outside the map reads 0.

``modulated_deform_conv`` launches ``csrc/dcn.cu``, a hand-written Hopper
kernel that replaces no TPU kernel (the JAX package has no deformable
convolution): one launch a layer, an implicit GEMM whose A operand is
gathered (M = B x H x W pixels, N = C_out, K = 9 x C_in). It is bound by its
``dcn_flops`` operations at the tensor cores' rate; see the source's note
for the design.

``dcn_reference`` is the plain PyTorch version of the kernel's arithmetic, on
any device: each tap's four corners gathered and weighted by their bilinear
weights times the mask, in float32 (float64 for float64 input), rounded to
the input's dtype, laid out as a (3H, 3W) tap image, then a 3x3 convolution
of stride 3 accumulated in float32 and rounded once. It is differentiable in
the input, the offsets, the mask and the weight: training, export and the
CPU run it.

The kernel takes CUDA tensors with channels_last strides (contiguous (B, H,
W, C) memory for ``x`` and ``om``, (C_out, 3, 3, C_in) for the weight), one
dtype of bfloat16 and float32, C_in a multiple of 32, C_out a multiple of
128, fewer than 2**31 values in each of ``x``, ``om`` and the output, 16-byte
aligned. ``modulated_deform_conv`` raises on anything else; CPU tensors of
that form take ``dcn_reference``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from rtm3d_tpu_torch.utils import kernel_build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
OFFSET_CHANNELS = 27  # 9 (dy, dx) pairs, then 9 mask logits
_BK = 32  # input channels of one K step (csrc/dcn.cu)
_BN = 128  # output channels of one block (csrc/dcn.cu)


def deform_taps(x: torch.Tensor, om: torch.Tensor) -> torch.Tensor:
    """The (B, C, 3H, 3W) tap image of ``x`` (B, C, H, W) under the offsets
    and mask logits ``om`` (B, 27, H, W): pixel (3h + i, 3w + j) holds tap
    k = 3i + j of output pixel (h, w), sampled and multiplied by its mask,
    in ``x``'s dtype."""
    B, C, H, W = x.shape
    k = torch.arange(9, device=x.device)
    py = torch.arange(H, device=x.device).view(1, 1, H, 1) - 1 + (k // 3).view(1, 9, 1, 1) + om[:, 0:18:2]
    px = torch.arange(W, device=x.device).view(1, 1, 1, W) - 1 + (k % 3).view(1, 9, 1, 1) + om[:, 1:18:2]
    mask = torch.sigmoid(om[:, 18:27])
    inside = (py > -1) & (px > -1) & (py < H) & (px < W)
    y0, x0 = torch.floor(py), torch.floor(px)
    ly, lx = py - y0, px - x0
    flat = x.reshape(B, C, H * W)
    taps = torch.zeros((B, C, 9, H, W), dtype=x.dtype, device=x.device)
    for dy, dx, weight in ((0, 0, (1 - ly) * (1 - lx)), (0, 1, (1 - ly) * lx), (1, 0, ly * (1 - lx)), (1, 1, ly * lx)):
        yy, xx = y0 + dy, x0 + dx
        ok = inside & (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        idx = (yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)).long().view(B, 1, 9 * H * W)
        corner = torch.gather(flat, 2, idx.expand(B, C, 9 * H * W)).view(B, C, 9, H, W)
        taps = taps + corner * torch.where(ok, weight * mask, 0.0).unsqueeze(1)
    return taps.view(B, C, 3, 3, H, W).permute(0, 1, 4, 2, 5, 3).reshape(B, C, 3 * H, 3 * W)


def dcn_reference(x: torch.Tensor, om: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device and layout:
    (B, C_out, H, W) in ``x``'s dtype."""
    acc = torch.promote_types(x.dtype, torch.float32)
    taps = deform_taps(x.to(acc), om.to(acc)).to(x.dtype)  # rounded as the kernel rounds its A tile
    return F.conv2d(taps.to(acc), weight.to(acc), stride=3).to(x.dtype)


def dcn_flops(batch: int, c_in: int, c_out: int, hw) -> int:
    """Operations of one call: two per multiply-add of each output, tap
    and input channel."""
    H, W = hw
    return 2 * 9 * c_in * c_out * batch * H * W


def _refusal(x: torch.Tensor, om: torch.Tensor, weight: torch.Tensor) -> str | None:
    """What the kernel needs that these tensors lack, or None when it takes
    them. CPU tensors pass where CUDA tensors would."""
    if x.dim() != 4 or om.dim() != 4 or weight.dim() != 4:
        return f"4-D x, offsets and weight, got {x.dim()}, {om.dim()} and {weight.dim()} dimensions"
    B, C, H, W = x.shape
    if tuple(om.shape) != (B, OFFSET_CHANNELS, H, W):
        return f"offsets of shape {(B, OFFSET_CHANNELS, H, W)}, got {tuple(om.shape)}"
    if tuple(weight.shape[1:]) != (C, 3, 3):
        return f"a weight of shape (C_out, {C}, 3, 3), got {tuple(weight.shape)}"
    if x.dtype not in _DTYPE_CODE or om.dtype != x.dtype or weight.dtype != x.dtype:
        return f"one dtype of {sorted(map(str, _DTYPE_CODE))}, got {[str(t.dtype) for t in (x, om, weight)]}"
    c_out = weight.shape[0]
    if C % _BK or C == 0:
        return f"an input channel count that is a multiple of {_BK}, got {C}"
    if c_out % _BN or c_out == 0:
        return f"an output channel count that is a multiple of {_BN}, got {c_out}"
    if B * H * W * max(C, c_out, OFFSET_CHANNELS) >= 2 ** 31:
        return f"fewer than 2**31 values in each map, got {B * H * W * max(C, c_out, OFFSET_CHANNELS)}"
    if not all(t.is_contiguous(memory_format=torch.channels_last) for t in (x, om, weight)):
        return "channels_last x, offsets and weight (contiguous (B, H, W, C) and (C_out, 3, 3, C_in) memory)"
    if om.device != x.device or weight.device != x.device or x.device.type not in ("cpu", "cuda"):
        return f"tensors on one device, the CPU or a CUDA device, got {[str(t.device) for t in (x, om, weight)]}"
    if any(t.data_ptr() % 16 for t in (x, om, weight)):
        return "16-byte aligned tensors"
    return None


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = kernel_build.load("dcn")
    fn = lib.dcn_forward_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def modulated_deform_conv(x: torch.Tensor, om: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``y`` (B, C_out, H, W), channels_last, in ``x``'s dtype. Raises on
    tensors the kernel does not take (module docstring); then CPU tensors
    take ``dcn_reference``, CUDA tensors the kernel's one launch on the
    current stream, with no host sync."""
    why = _refusal(x, om, weight)
    if why is not None:
        raise ValueError(f"modulated_deform_conv: the kernel takes {why}")
    if x.device.type == "cpu":
        return dcn_reference(x, om, weight)
    B, C, H, W = x.shape
    c_out = weight.shape[0]
    out = torch.empty((B, c_out, H, W), dtype=x.dtype, device=x.device, memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _library().dcn_forward_launch(x.data_ptr(), om.data_ptr(), weight.data_ptr(), out.data_ptr(),
                                            B, H, W, C, c_out, _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"dcn kernel launch failed: CUDA error {err}")
    modulated_deform_conv.launches += 1
    return out


modulated_deform_conv.launches = 0  # kernel launches since the last reset: one a call
