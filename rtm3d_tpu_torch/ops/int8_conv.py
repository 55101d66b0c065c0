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

``conv_s8`` runs one of a few variants of the kernel (``conv_variant``),
chosen from the shape alone: how the input tile is loaded (``tma``, a TMA
tensor map per tap, for stride 1 and Cp % 128 == 0; ``gather16``, 16-byte
cp.async pieces, for Cp % 16 == 0; ``gather4``, 4-byte pieces, for the
3-channel stem), the N tile (Cout rounded up to 16, 32, 64, 128 or 256)
and, for ``tma``, the tile's output rows and columns. A shape no variant
takes raises ``ValueError`` here, before the launch; a launch the card
refuses raises ``RuntimeError``.

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
TILE_K = 32  # Kp is a multiple of it: one wgmma step of K (csrc/int8_conv.cu)
# csrc/int8_conv.cu's block and ring, mirrored for conv_variant
TILE_M = 128  # kTileM: output pixels of a block
CHUNK = 128  # kChunk: K bytes of one ring stage
N_TILES = (16, 32, 64, 128, 256)  # the wgmma widths the kernel is built for
LOADS = {"tma": 0, "gather16": 1, "gather4": 2}  # the kernel's Load codes
MAX_BYTES = 2 ** 31  # the kernels index the input and the output pixels with 32-bit ints
MAX_PIECES = 512  # kMaxPieces: the gather's table of its pieces of K (16 or 4 bytes each)
SMEM_LIMIT = 232_448  # dynamic shared memory a block may hold on an H100


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


def _tma_tile(ho: int, wo: int) -> tuple:
    """(bh, bw): the tma variant's 128 output pixels as bh rows of bw, the
    width of 8 to 128 that covers Ho x Wo with the fewest pixels (the widest
    on a tie)."""
    best = None
    for bw in (128, 64, 32, 16, 8):
        bh = TILE_M // bw
        covered = -(-wo // bw) * bw * (-(-ho // bh) * bh)
        if best is None or covered < best[0]:
            best = (covered, bh, bw)
    return best[1], best[2]


def conv_variant(n: int, h: int, w: int, cp: int, cout: int, kernel_size, stride: int, padding: int,
                 dilation: int, kp: int, out_itemsize: int = 2) -> dict:
    """The kernel variant ``conv_s8`` launches for this shape, from the shape
    alone: ``load`` (``tma`` for stride 1 and Cp % 128 == 0, ``gather16``
    for Cp % 16 == 0, else ``gather4``), ``bn`` (the N tile: Cout rounded up
    to a wgmma width, at most 256), for ``tma`` the tile's ``bh`` x ``bw``
    output rows and columns, the ``tiles`` (M tiles, N tiles) the
    persistent blocks walk, the K chunks of a tile (``k_tiles``), the ring's
    ``stages`` and a block's dynamic shared memory (``smem`` for an output
    of ``out_itemsize`` bytes, as the kernel's ``Ring``). Raises
    ``ValueError`` for a shape no variant takes."""
    kh, kw = kernel_size
    ho, wo = out_hw(h, w, kernel_size, stride, padding, dilation)
    k = kh * kw * cp
    why = []
    if cp <= 0 or cp % 4:
        why.append(f"Cp {cp} not a positive multiple of 4")
    if kp % TILE_K or kp < k:
        why.append(f"Kp {kp} not a multiple of {TILE_K} of at least KH*KW*Cp = {k}")
    if min(n, h, w, cout, ho, wo, stride, dilation) <= 0 or padding < 0:
        why.append(f"an empty or negative extent (N {n}, H {h}, W {w}, Cout {cout}, out {ho}x{wo})")
    if n * h * w * cp >= MAX_BYTES or n * ho * wo >= MAX_BYTES:
        why.append(f"input {n}x{h}x{w}x{cp} or {n * ho * wo} output pixels past 32-bit offsets")
    bn = next((b for b in N_TILES if b >= cout), N_TILES[-1])
    if -(-cout // bn) > 65535:
        why.append(f"Cout {cout} needs more than 65535 N tiles")
    tma = stride == 1 and cp % CHUNK == 0
    piece = 16 if cp % 16 == 0 else 4
    if not tma and (-(-k // piece) > MAX_PIECES or max(kh - 1, kw - 1) * dilation >= 256):
        why.append(f"a gather of {-(-k // piece)} pieces (at most {MAX_PIECES}) or taps {dilation}x{kh - 1} apart")
    if why:
        raise ValueError("conv_s8: no kernel variant takes this shape: " + "; ".join(why))
    if tma:
        load = "tma"
        bh, bw = _tma_tile(ho, wo)
        tiles = n * -(-ho // bh) * -(-wo // bw)
    else:
        load = "gather16" if cp % 16 == 0 else "gather4"
        bh, bw = 1, TILE_M
        tiles = -(-(n * ho * wo) // TILE_M)
    stages = 3 if bn in (16, 64) else 4  # at N 16 and 64, 3 keep three and two blocks on an SM
    staged_row = min(bn * out_itemsize, 128)  # the epilogue's bytes a row in each of its two buffers
    smem = stages * (TILE_M * CHUNK + bn * CHUNK) + 2 * TILE_M * staged_row + 2 * stages * 8 + 4 * MAX_PIECES
    return {"name": f"{load}_n{bn}" + (f"_{bh}x{bw}" if load == "tma" else ""), "load": load, "bn": bn,
            "bh": bh, "bw": bw, "tiles": [tiles, -(-cout // bn)], "k_tiles": -(-kp // CHUNK), "stages": stages,
            "smem": smem}


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
    c.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 18 + [ctypes.c_void_p]
    c.restype = ctypes.c_int
    lib.int8_conv_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.int8_conv_smem_bytes.restype = ctypes.c_int
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
    kernel's variant for the shape (``conv_variant``) or raise."""
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
    if n * ho * wo * cout == 0:
        return torch.empty((n, ho, wo, cout), dtype=out_dtype, device=device)
    v = conv_variant(n, h, wd, cp, cout, (kh, kw), int(stride), int(padding), int(dilation), kp)
    y = torch.empty((n, ho, wo, cout), dtype=out_dtype, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _library().int8_conv_launch(
            xq.data_ptr(), w.data_ptr(), out_scale.data_ptr(), bias.data_ptr() if bias is not None else None,
            y.data_ptr(), _DTYPE_CODE[out_dtype], n, h, wd, cp, cout, kh, kw, int(stride), int(padding),
            int(dilation), ho, wo, kp, LOADS[v["load"]], v["bn"], v["bh"], v["bw"], stream,
        )
    if err != 0:
        raise RuntimeError(f"int8 conv kernel launch failed: CUDA error {err}")
    conv_s8.launches += 1
    return y


quantize.launches = 0  # kernel launches since the last reset
conv_s8.launches = 0
