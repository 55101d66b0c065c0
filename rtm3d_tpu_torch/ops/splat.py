"""The Gaussian heatmap target splat: CUDA kernel wrapper and plain version.

``splat_heatmap`` launches ``csrc/splat.cu``, the hand-written Hopper
kernel that replaces ``rtm3d_tpu/ops/splat.py::_splat_kernel`` (the Pallas
TPU kernel): one block per tile of one image (the kernel's shape, which
``splat_tile_shape`` reads; the grid is ``splat_launch_geometry``'s), four
pixels a thread, max over the slots that reach the tile. It is bound by the
bytes of its output (``splat_bytes``), not by its operations
(``splat_flops``); see the source's note for the design.

Semantics (reference: datasets/dataset_reader.py:262-279 with
utils/data_utils.py:127-141): per class channel, the max over masked slots
of a dense Gaussian ``exp(-d^2 / 2 sigma^2)`` about the slot's integer
center, cut to the square window |dx| <= R, |dy| <= R; a noise slot's
center is 0.9999; a pixel no slot reaches is 0.

Layout: the port's, NCHW. Inputs m_proj (B, N, 2) int32 (x, y), cls (B, N)
int32 (clipped to [0, C-1]), sigma and radius (B, N) float32, mask and
noise (B, N) bool; output (B, C, H, W) float32. The JAX package's public
layout is NHWC (``splat_heatmap_pallas`` transposes at the end), so the
tests transpose to compare.

``splat_heatmap_reference`` is the plain PyTorch version, the port of
``rtm3d_tpu/data/targets.py::_render_heatmap`` (a loop over the slots).
``splat_heatmap`` takes it for CPU tensors only; on CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from rtm3d_tpu_torch.utils import kernel_build

# Bytes read per slot: m_proj 8, cls 4, sigma 4, radius 4, mask 1, noise 1.
_BYTES_PER_SLOT = 22
# Operations per pixel inside a slot's window, counted from csrc/splat.cu
# with add, sub, mul and div as 1 (compares, selects, converts and max as
# 0): dx, dy (2); dx*dx + dy*dy (3); the divide (1); expf (1).
_FLOPS_PER_WINDOW_PIXEL = 7
_FLOPS_PER_SLOT = 2  # 2 * sigma * sigma, once per staged slot


def splat_bytes(batch: int, n_slots: int, feat_hw, num_classes: int) -> int:
    """Bytes one call must move: each input read once, the output written once."""
    H, W = feat_hw
    return batch * n_slots * _BYTES_PER_SLOT + batch * num_classes * H * W * 4


def splat_flops(m_proj: torch.Tensor, radius: torch.Tensor, mask: torch.Tensor, feat_hw) -> int:
    """Operations these inputs need: every masked slot evaluates the pixels
    of its window that lie on the map."""
    H, W = feat_hw
    r = torch.floor(radius.float()).clamp(min=0).long()
    cx, cy = m_proj[..., 0].long(), m_proj[..., 1].long()
    nx = ((cx + r).clamp(max=W - 1) - (cx - r).clamp(min=0) + 1).clamp(min=0)
    ny = ((cy + r).clamp(max=H - 1) - (cy - r).clamp(min=0) + 1).clamp(min=0)
    pixels = (nx * ny * (radius >= 0) * mask).sum().item()
    return int(pixels) * _FLOPS_PER_WINDOW_PIXEL + int(mask.sum().item()) * _FLOPS_PER_SLOT


def splat_launch_geometry(batch: int, height: int, width: int, tile) -> Tuple[int, int, int]:
    """(grid_x, grid_y, grid_z) of a launch: one block per ``tile`` (rows,
    columns) of one image, the last tile of a row or column cut by the
    map's edge."""
    tile_h, tile_w = tile
    return -(-width // tile_w), -(-height // tile_h), batch


def splat_live_slots(m_proj: torch.Tensor, radius: torch.Tensor, mask: torch.Tensor, feat_hw,
                     tile) -> torch.Tensor:
    """(B, grid_y, grid_x): the slots the kernel keeps for each ``tile``,
    those masked in whose window (or noise center) reaches the tile, as
    csrc/splat.cu tests them."""
    H, W = (int(v) for v in feat_hw)
    th, tw = tile
    gx, gy, _ = splat_launch_geometry(mask.shape[0], H, W, tile)
    dev = m_proj.device
    x0, y0 = torch.arange(gx, device=dev) * tw, torch.arange(gy, device=dev) * th
    x1, y1 = (x0 + tw).clamp(max=W) - 1, (y0 + th).clamp(max=H) - 1
    cx, cy = m_proj[..., 0:1].long(), m_proj[..., 1:2].long()  # (B, N, 1)
    zero = torch.zeros((), dtype=torch.long, device=dev)
    gap_x = torch.maximum(torch.maximum(x0 - cx, cx - x1), zero)
    gap_y = torch.maximum(torch.maximum(y0 - cy, cy - y1), zero)
    reach = radius.float().clamp(min=0)[..., None]
    live = ((gap_x.float() <= reach)[:, :, None, :] & (gap_y.float() <= reach)[:, :, :, None]
            & mask.bool()[:, :, None, None])  # (B, N, grid_y, grid_x)
    return live.sum(1)


def splat_heatmap_reference(m_proj, cls, sigma, radius, mask, noise, feat_hw, num_classes: int):
    """Plain PyTorch version of the kernel, on any device: one dense pass
    over the (B, H, W) grid per slot, max-combined."""
    H, W = feat_hw
    B, N = cls.shape
    dev = m_proj.device
    xs = torch.arange(W, dtype=torch.int32, device=dev).view(1, 1, W)
    ys = torch.arange(H, dtype=torch.int32, device=dev).view(1, H, 1)
    cls = cls.to(torch.int32).clamp(0, num_classes - 1)
    classes = torch.arange(num_classes, dtype=torch.int32, device=dev).view(1, num_classes)
    noise = noise & mask
    hm = torch.zeros((B, num_classes, H, W), dtype=torch.float32, device=dev)
    for n in range(N):
        dx = xs - m_proj[:, n, 0].view(B, 1, 1)
        dy = ys - m_proj[:, n, 1].view(B, 1, 1)
        rad = radius[:, n].float().view(B, 1, 1)
        in_win = (dx.abs() <= rad) & (dy.abs() <= rad)
        d2 = (dx * dx + dy * dy).float()
        sg = sigma[:, n].float().view(B, 1, 1)
        g = torch.where(in_win, torch.exp(-d2 / (2.0 * sg * sg)), 0.0)
        g = torch.where(noise[:, n].view(B, 1, 1) & (dx == 0) & (dy == 0), 0.9999, g)
        g = torch.where(mask[:, n].view(B, 1, 1), g, 0.0)
        onehot = (cls[:, n : n + 1] == classes).view(B, num_classes, 1, 1)
        hm = torch.maximum(hm, torch.where(onehot, g[:, None], 0.0))
    return hm


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = kernel_build.load("splat")
    fn = lib.splat_heatmap_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.splat_max_classes.argtypes = []
    lib.splat_max_classes.restype = ctypes.c_int
    lib.splat_tile_shape.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    lib.splat_tile_shape.restype = None
    return lib


@functools.lru_cache(maxsize=None)
def splat_tile_shape() -> Tuple[int, int]:
    """The kernel's tile, (rows, columns) of pixels, read from the built
    library (csrc/splat.cu)."""
    h, w = ctypes.c_int(), ctypes.c_int()
    _library().splat_tile_shape(ctypes.byref(h), ctypes.byref(w))
    return h.value, w.value


def splat_heatmap(m_proj, cls, sigma, radius, mask, noise, feat_hw, num_classes: int):
    """Class heatmap (B, C, H, W). CPU tensors take ``splat_heatmap_reference``;
    CUDA tensors launch the kernel on the current stream (or raise)."""
    H, W = (int(v) for v in feat_hw)
    B, N = cls.shape
    tensors = {
        "m_proj": (m_proj, (B, N, 2), torch.int32), "cls": (cls, (B, N), torch.int32),
        "sigma": (sigma, (B, N), torch.float32), "radius": (radius, (B, N), torch.float32),
        "mask": (mask, (B, N), torch.bool), "noise": (noise, (B, N), torch.bool),
    }
    for name, (t, shape, _) in tensors.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"splat_heatmap: {name} must be {shape}, got {tuple(t.shape)}")
    devices = {t.device for t, _, _ in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"splat_heatmap: inputs on several devices {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return splat_heatmap_reference(m_proj, cls, sigma, radius, mask, noise, (H, W), num_classes)
    if device.type != "cuda":
        raise ValueError(f"splat_heatmap: no kernel for device {device}")
    for name, (t, _, dtype) in tensors.items():
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"splat_heatmap: {name} must be contiguous {dtype}, got {t.dtype}")
    lib = _library()
    if not 1 <= num_classes <= lib.splat_max_classes():
        raise ValueError(f"splat_heatmap: the kernel takes 1..{lib.splat_max_classes()} classes, got {num_classes}")
    out = torch.empty((B, num_classes, H, W), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    grid_x, grid_y, _ = splat_launch_geometry(B, H, W, splat_tile_shape())
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.splat_heatmap_launch(
            m_proj.data_ptr(), cls.data_ptr(), sigma.data_ptr(), radius.data_ptr(),
            mask.data_ptr(), noise.data_ptr(), out.data_ptr(), B, N, H, W, int(num_classes),
            grid_x, grid_y, stream,
        )
    if err != 0:
        raise RuntimeError(f"splat kernel launch failed: CUDA error {err}")
    splat_heatmap.launches += 1
    return out


splat_heatmap.launches = 0  # kernel launches since the last reset
