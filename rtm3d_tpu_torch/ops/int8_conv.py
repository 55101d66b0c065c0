"""int8 activation quantize and int8 convolution: CUDA kernel wrappers and plain versions.

``quantize`` and ``conv_s8`` launch ``csrc/int8_conv.cu``, hand-written
Hopper kernels that replace no TPU kernel: the JAX package runs its int8
convolution as XLA's ``conv_general_dilated`` on int8 operands with int32
accumulation (``rtm3d_tpu/nn/quant.py:254-262``), and PyTorch has no int8
convolution on CUDA. ``nn/quant.py::QuantConv`` calls the two in turn.

Layouts: activations NHWC. ``quantize`` takes a float tensor (N, C, H, W)
of any strides (the network's channels_last activations are an NCHW view of
NHWC memory) and returns int8 (N, H, W, Cp), the channels padded with zeros
to ``padded_channels(C)``; ``conv_s8`` takes that, the weights packed by
``pack_weight`` as (Cout, Kp) rows of taps (r, c, ci) zero past KH*KW*Cp,
and returns (N, Ho, Wo, Cout) in the requested float type.

``quantize_reference`` and ``conv_s8_reference`` are the plain PyTorch
versions: the same division and rounding, then ``F.conv2d`` in float64 on
the int8 values, which is exact (|acc| <= 127^2 * KH*KW*Cin < 2^53 for every
conv of DLA-34 and ResNet-18/50; the sum is rounded to the integer it is in
case cuDNN picks a transform algorithm), then the same epilogue. The
wrappers take them for CPU tensors only; on CUDA tensors they launch the
kernels or raise.

Every division here is by a tensor, never by a Python scalar: on CUDA
``tensor / python_float`` multiplies by the reciprocal, which can differ
from IEEE division in the last bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from rtm3d_tpu_torch.utils import kernel_build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
TILE_K = 32  # csrc/int8_conv.cu's kTileK: Kp is a multiple of it


def padded_channels(c: int) -> int:
    """The channels the conv reads: C where C % 16 == 0 (16-byte loads), else
    C rounded up to a multiple of 4 (the 3-channel stem reads 4)."""
    return c if c % 16 == 0 else -(-c // 4) * 4


def padded_taps(k: int) -> int:
    return -(-k // TILE_K) * TILE_K


def pack_weight(wq: torch.Tensor) -> torch.Tensor:
    """int8 weights (Cout, Cin, KH, KW) as the kernel reads them: (Cout, Kp)
    rows of taps in (r, c, ci) order, channels padded to
    ``padded_channels(Cin)`` and the row to ``padded_taps``, with zeros."""
    cout, cin, kh, kw = wq.shape
    cp = padded_channels(cin)
    w = torch.zeros((cout, kh, kw, cp), dtype=torch.int8, device=wq.device)
    w[..., :cin] = wq.permute(0, 2, 3, 1).to(torch.int8)
    w = w.reshape(cout, kh * kw * cp)
    return F.pad(w, (0, padded_taps(w.shape[1]) - w.shape[1])).contiguous()


def out_hw(h: int, w: int, kernel_size, stride: int, padding: int, dilation: int):
    kh, kw = kernel_size
    return ((h + 2 * padding - dilation * (kh - 1) - 1) // stride + 1,
            (w + 2 * padding - dilation * (kw - 1) - 1) // stride + 1)


def quantize_bytes(n: int, c: int, h: int, w: int, itemsize: int) -> int:
    """Bytes one quantize must move: the input once, the scales, the padded output once."""
    return n * h * w * (c * itemsize + padded_channels(c)) + 4 * c


def conv_s8_ops(n: int, cin: int, h: int, w: int, cout: int, kernel_size, stride: int, padding: int,
                dilation: int) -> int:
    """int8 operations of one conv (a multiply and an add per tap):
    2 * N * Ho * Wo * Cout * KH * KW * Cin."""
    ho, wo = out_hw(h, w, kernel_size, stride, padding, dilation)
    return 2 * n * ho * wo * cout * kernel_size[0] * kernel_size[1] * cin


def conv_s8_bytes(n: int, cin: int, h: int, w: int, cout: int, kernel_size, stride: int, padding: int,
                  dilation: int, out_itemsize: int) -> int:
    """Bytes one conv must move: the int8 input and weights once, the
    scales and biases, the output once."""
    ho, wo = out_hw(h, w, kernel_size, stride, padding, dilation)
    cp = padded_channels(cin)
    return (n * h * w * cp + cout * kernel_size[0] * kernel_size[1] * cin + 8 * cout
            + n * ho * wo * cout * out_itemsize)


def quantize_reference(x: torch.Tensor, scale: torch.Tensor, cpad: int) -> torch.Tensor:
    """Plain version, on any device: x (N, C, H, W) float, scale (C,) float32
    -> (N, H, W, cpad) int8, clip(round_half_even(x / s), -127, 127)."""
    xn = x.permute(0, 2, 3, 1).float()
    q = torch.round(xn / scale.to(xn.device, torch.float32)).clamp_(-127, 127).to(torch.int8)
    return F.pad(q, (0, cpad - q.shape[-1])).contiguous()


def conv_s8_reference(xq, w, kernel_size, stride: int, padding: int, dilation: int, out_scale, bias,
                      out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version, on any device: the exact integer convolution in float64,
    then ``float32(acc) * out_scale + bias``, cast to ``out_dtype``."""
    cp, cout = xq.shape[-1], w.shape[0]
    kh, kw = kernel_size
    wk = w[:, : kh * kw * cp].reshape(cout, kh, kw, cp).permute(0, 3, 1, 2).double()
    acc = F.conv2d(xq.permute(0, 3, 1, 2).double(), wk, stride=stride, padding=padding, dilation=dilation)
    y = torch.round(acc).float().permute(0, 2, 3, 1) * out_scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype).contiguous()


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = kernel_build.load("int8_conv")
    q = lib.int8_quantize_launch
    q.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_int64] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    q.restype = ctypes.c_int
    c = lib.int8_conv_launch
    c.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 14 + [ctypes.c_void_p]
    c.restype = ctypes.c_int
    return lib


def _device(name: str, *tensors) -> torch.device:
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices {devices}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {device}")
    return device


def quantize(x: torch.Tensor, scale: torch.Tensor, cpad: int) -> torch.Tensor:
    """int8 (N, H, W, cpad) of x (N, C, H, W) fp32 or bf16, any strides, by
    the per-channel ``scale`` (C,) float32. CPU tensors take
    ``quantize_reference``; CUDA tensors launch the kernel (or raise)."""
    if x.dim() != 4 or scale.shape != (x.shape[1],):
        raise ValueError(f"quantize: x must be (N, C, H, W) and scale (C,), got {tuple(x.shape)}, "
                         f"{tuple(scale.shape)}")
    n, c, h, w = x.shape
    if cpad < c or cpad % 4:
        raise ValueError(f"quantize: cpad {cpad} must be a multiple of 4 and at least C = {c}")
    device = _device("quantize", x, scale)
    if device.type == "cpu":
        return quantize_reference(x, scale, cpad)
    if x.dtype not in _DTYPE_CODE or scale.dtype != torch.float32 or not scale.is_contiguous():
        raise ValueError(f"quantize: x must be float32 or bfloat16 and scale contiguous float32, got "
                         f"{x.dtype}, {scale.dtype}")
    out = torch.empty((n, h, w, cpad), dtype=torch.int8, device=device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        sn, sc, sh, sw = x.stride()
        err = _library().int8_quantize_launch(x.data_ptr(), _DTYPE_CODE[x.dtype], sn, sc, sh, sw, n, c, h, w,
                                              scale.data_ptr(), cpad, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"int8 quantize kernel launch failed: CUDA error {err}")
    quantize.launches += 1
    return out


def conv_s8(xq: torch.Tensor, w: torch.Tensor, kernel_size, stride: int, padding: int, dilation: int,
            out_scale: torch.Tensor, bias: torch.Tensor | None, out_dtype: torch.dtype) -> torch.Tensor:
    """(N, Ho, Wo, Cout) ``out_dtype`` of the int8 conv of xq (N, H, W, Cp)
    by the packed weights w (Cout, Kp), then ``float(acc) * out_scale +
    bias``. CPU tensors take ``conv_s8_reference``; CUDA tensors launch the
    kernel (or raise)."""
    kh, kw = (int(v) for v in kernel_size)
    if xq.dim() != 4 or w.dim() != 2:
        raise ValueError(f"conv_s8: xq must be (N, H, W, Cp) and w (Cout, Kp), got {tuple(xq.shape)}, "
                         f"{tuple(w.shape)}")
    n, h, wd, cp = xq.shape
    cout, kp = w.shape
    if kp % TILE_K or kp < kh * kw * cp or cp % 4:
        raise ValueError(f"conv_s8: Kp {kp} must be a multiple of {TILE_K} and at least KH*KW*Cp = "
                         f"{kh * kw * cp}, Cp {cp} a multiple of 4")
    if out_scale.shape != (cout,) or (bias is not None and bias.shape != (cout,)):
        raise ValueError(f"conv_s8: out_scale and bias must be ({cout},)")
    device = _device("conv_s8", xq, w, out_scale, bias)
    if device.type == "cpu":
        return conv_s8_reference(xq, w, (kh, kw), stride, padding, dilation, out_scale, bias, out_dtype)
    if (xq.dtype != torch.int8 or w.dtype != torch.int8 or out_dtype not in _DTYPE_CODE
            or not all(t.is_contiguous() for t in (xq, w, out_scale))
            or out_scale.dtype != torch.float32
            or (bias is not None and (bias.dtype != torch.float32 or not bias.is_contiguous()))):
        raise ValueError("conv_s8: xq and w must be contiguous int8, out_scale and bias contiguous float32, "
                         f"out_dtype float32 or bfloat16; got {xq.dtype}, {w.dtype}, {out_scale.dtype}, {out_dtype}")
    ho, wo = out_hw(h, wd, (kh, kw), stride, padding, dilation)
    y = torch.empty((n, ho, wo, cout), dtype=out_dtype, device=device)
    if y.numel() == 0:
        return y
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _library().int8_conv_launch(
            xq.data_ptr(), w.data_ptr(), out_scale.data_ptr(), bias.data_ptr() if bias is not None else None,
            y.data_ptr(), _DTYPE_CODE[out_dtype], n, h, wd, cp, cout, kh, kw, int(stride), int(padding),
            int(dilation), ho, wo, kp, stream,
        )
    if err != 0:
        raise RuntimeError(f"int8 conv kernel launch failed: CUDA error {err}")
    conv_s8.launches += 1
    return y


quantize.launches = 0  # kernel launches since the last reset
conv_s8.launches = 0
