"""The KFPN's softmax-attention fusion: CUDA kernel wrapper and plain version.

    z = x0 + sum_i up_i * softmax_HW(up_i)

over the upsampled maps ``ups`` in the order given (the KFPN's loop: level
5, then 4, then 3), each softmax per (image, channel) over H x W.
``kfpn_fuse`` launches ``csrc/kfpn_fuse.cu``, a hand-written Hopper kernel
that replaces no TPU kernel (the JAX package leaves this fusion to XLA):
one launch for every map's per-channel statistics, one that weights the
maps and writes ``z``. It is bound by the bytes it must move
(``kfpn_fuse_bytes``); see the source's note for the design.

``kfpn_fuse_reference`` is the plain PyTorch version of the kernel's
arithmetic, on any device: per channel the max and the sum of
exponentials, then the weighted sum, accumulated in float32 (float64 for
float64 maps) in the maps' order and rounded once to their dtype.

The kernel takes CUDA tensors of one shape (B, C, H, W) with channels_last
strides (contiguous (B, H, W, C) memory), one dtype of bfloat16 and float32
(the detect step's compute dtypes), C a multiple of 8 up to 1,024, fewer
than 2**31 values an image (C x H x W), one to four upsampled maps,
16-byte aligned. ``kfpn_fuse`` raises on anything
else; CPU maps of that form take ``kfpn_fuse_reference``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from rtm3d_tpu_torch.utils import kernel_build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VEC = 8  # channels a thread owns (csrc/kfpn_fuse.cu)
_APPLY_THREADS = 256  # at most, per apply block
_APPLY_BLOCKS_PER_SM = 4  # the apply grid's target, in blocks a streaming multiprocessor
_CLUSTER = 8  # statistics blocks of one (map, image, channel slice)
_STATS_BLOCKS_PER_SM = 2  # the statistics grid's target
_MIN_SLICE = 32  # channels of a statistics block, at least (64 contiguous bytes in bf16)


def kfpn_fuse_reference(x0: torch.Tensor, ups: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device and layout."""
    acc = torch.promote_types(x0.dtype, torch.float32)
    z = x0.to(acc)
    for up in ups:
        u = up.to(acc)
        e = torch.exp(u - u.amax(dim=(2, 3), keepdim=True)).detach()  # the weights take no gradient
        z = z + u * (e / e.sum(dim=(2, 3), keepdim=True))
    return z.to(x0.dtype)


def kfpn_fuse_bytes(batch: int, channels: int, hw, n_ups: int, itemsize: int) -> int:
    """Bytes one call must move: every upsampled map read for its
    statistics and again to weight it, x0 read and z written once."""
    H, W = hw
    return (2 * n_ups + 2) * batch * channels * H * W * itemsize


def _refusal(x0: torch.Tensor, ups: Sequence[torch.Tensor]) -> str | None:
    """What the kernel needs that these maps lack, or None when it takes
    them. CPU maps pass where CUDA maps would."""
    maps = [x0, *ups]
    if not 1 <= len(ups) <= 4:
        return f"1 to 4 upsampled maps, got {len(ups)}"
    if x0.dim() != 4 or any(t.shape != x0.shape for t in maps):
        return f"maps of one (B, C, H, W) shape, got {[tuple(t.shape) for t in maps]}"
    if x0.dtype not in _DTYPE_CODE or any(t.dtype != x0.dtype for t in maps):
        return f"maps of one dtype of {sorted(map(str, _DTYPE_CODE))}, got {[str(t.dtype) for t in maps]}"
    C = x0.shape[1]
    if C % _VEC or not 0 < C <= 1024:
        return f"a channel count that is a multiple of {_VEC} up to 1024, got {C}"
    if C * x0.shape[2] * x0.shape[3] >= 2 ** 31:
        return f"fewer than 2**31 values an image (C x H x W), got {C * x0.shape[2] * x0.shape[3]}"
    if not all(t.is_contiguous(memory_format=torch.channels_last) for t in maps):
        return "channels_last maps (contiguous (B, H, W, C) memory)"
    if any(t.device != x0.device for t in maps) or x0.device.type not in ("cpu", "cuda"):
        return f"maps on one device, the CPU or a CUDA device, got {[str(t.device) for t in maps]}"
    if any(t.data_ptr() % 16 for t in maps):
        return "16-byte aligned maps"
    return None


def kfpn_fuse_stats_slices(batch: int, channels: int, n_ups: int, sms: int) -> int:
    """The channel slices of a statistics block: the fewest, a power of 2,
    whose grid of ``8 x batch x n_ups x slices`` blocks reaches
    ``_STATS_BLOCKS_PER_SM`` blocks a streaming multiprocessor, with
    slices of at least ``_MIN_SLICE`` channels, a multiple of 8."""
    slices = 1
    while (_CLUSTER * batch * n_ups * slices < _STATS_BLOCKS_PER_SM * sms
           and channels % (2 * slices * _VEC) == 0 and channels // (2 * slices) >= _MIN_SLICE):
        slices *= 2
    return slices


def kfpn_fuse_apply_blocks(batch: int, channels: int, hw: int, sms: int) -> int:
    """The apply launch's blocks an image: about ``_APPLY_BLOCKS_PER_SM``
    blocks a streaming multiprocessor over the batch, and no block without
    a pixel (a block holds ``256 // (channels / 8)`` pixel lanes)."""
    groups = channels // _VEC
    lanes = _APPLY_THREADS // groups
    return max(1, min(-(-hw // lanes), -(-_APPLY_BLOCKS_PER_SM * sms // batch)))


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = kernel_build.load("kfpn_fuse")
    fn = lib.kfpn_fuse_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def kfpn_fuse(x0: torch.Tensor, ups: Sequence[torch.Tensor]) -> torch.Tensor:
    """``z`` (B, C, H, W), channels_last, in the maps' dtype. Raises on maps
    the kernel does not take (module docstring); then CPU maps take
    ``kfpn_fuse_reference``, CUDA maps the kernel's two launches on the
    current stream, with no host sync."""
    why = _refusal(x0, ups)
    if why is not None:
        raise ValueError(f"kfpn_fuse: the kernel takes {why}")
    if x0.device.type == "cpu":
        return kfpn_fuse_reference(x0, ups)
    B, C, H, W = x0.shape
    device = x0.device
    out = torch.empty_like(x0, memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    stats = torch.empty((2, len(ups), B, C), dtype=torch.float32, device=device)
    ptrs = [t.data_ptr() for t in ups] + [None] * (4 - len(ups))
    sms = _sm_count(device.index)
    slices = kfpn_fuse_stats_slices(B, C, len(ups), sms)
    blocks_x = kfpn_fuse_apply_blocks(B, C, H * W, sms)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _library().kfpn_fuse_launch(
            x0.data_ptr(), *ptrs, len(ups), stats.data_ptr(), out.data_ptr(), B, C, H * W,
            _DTYPE_CODE[x0.dtype], slices, blocks_x, stream,
        )
    if err != 0:
        raise RuntimeError(f"kfpn_fuse kernel launch failed: CUDA error {err}")
    kfpn_fuse.launches += 2
    return out


kfpn_fuse.launches = 0  # kernel launches since the last reset: two a call
