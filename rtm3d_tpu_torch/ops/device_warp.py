"""The device-side image warp: resize, scale augmentation, mirror and pad
as two batched matrix products.

Port of ``rtm3d_tpu/ops/device_warp.py:31-114``. Every geometric
transform of the reader (reference transforms.py:480-495, 325-369,
448-477; dataset_reader.py:175-195) is axis-aligned, so the bilinear warp
is separable, and a separable 1-D bilinear resample is a matrix with two
non-zeros a row:

    out[b] = R(b) @ src[b] @ C(b)^T        (rows, then columns)

The host ships raw uint8 frames (or, with the device dataset cache, only
their index) plus 6 scalars per image; the interpolation matrices are
built on the device from ``arange``. Where the warped frame leaves the
source it blends to the per-image border colour, as the host path's
mean-colour padding does.

The JAX package computes this with XLA einsums, outside any Pallas
kernel, and so does the port, with ``torch.matmul``. The products run in
float32 with TF32 off: at TF32's 10-bit mantissa a 255-level pixel moves
by about 0.1 grey level.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import numpy as np
import torch


@contextlib.contextmanager
def _no_tf32():
    """IEEE float32 products on the GPU for the block (restores the flag)."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def _on(device, values) -> torch.Tensor:
    """A small float32 constant on ``device``. The copy does not wait for
    the stream (a blocking copy would synchronise it in mid-step); its
    source is staged at once, so the temporary may go."""
    return torch.tensor(values, dtype=torch.float32).to(device, non_blocking=True)


def _interp_matrix(n_out: int, n_in: int, scale: torch.Tensor, offset: torch.Tensor,
                   n_valid: torch.Tensor) -> torch.Tensor:
    """(B, n_out, n_in) bilinear weights for src = (dst - offset) / scale.

    ``scale`` (B,) may be negative (mirror). Rows whose source position
    falls outside the valid source extent get zero coverage (the caller's
    border blend fills them). ``n_valid`` (B,) masks a smaller true source
    inside a padded canvas: columns past it are never sampled."""
    dev = scale.device
    dst = torch.arange(n_out, dtype=torch.float32, device=dev)[None, :, None]
    src = (dst - offset[:, None, None]) / scale[:, None, None]  # (B, n_out, 1)
    j = torch.arange(n_in, dtype=torch.float32, device=dev)[None, None, :]
    nv = n_valid[:, None, None]
    w = torch.clamp(1.0 - (src - j).abs(), min=0.0)  # 2-tap bilinear rows
    w = w * (j <= nv - 1)
    inb = ((src >= -0.5) & (src <= nv - 0.5)).to(torch.float32)
    return w * inb


def device_warp(
    images: torch.Tensor,  # (B, Hs, Ws, 3) uint8 or float
    params: torch.Tensor,  # (B, 4|6): sx, sy, tx, ty [, w0, h0 true source size]
    out_hw: Tuple[int, int],
    mean,
    std,
    border: torch.Tensor = None,  # (B, 3); default: per-image mean colour
) -> torch.Tensor:
    """Batched warp + normalise. Returns (B, H, W, 3) float32, contiguous."""
    H, W = out_hw
    B, Hs, Ws, C = images.shape
    x = images.to(torch.float32)
    if border is None:
        border = x.mean(dim=(1, 2))
    border = border.to(torch.float32)
    p = params.to(torch.float32)
    if p.shape[-1] == 4:
        p = torch.cat([p, _on(p.device, [Ws, Hs]).expand(B, 2)], dim=-1)
    sx, sy, tx, ty, w0, h0 = p.unbind(-1)
    R = _interp_matrix(H, Hs, sy, ty, h0)  # (B, H, Hs)
    Cm = _interp_matrix(W, Ws, sx, tx, w0)  # (B, W, Ws)
    with _no_tf32():
        t = torch.matmul(R, x.reshape(B, Hs, Ws * C)).reshape(B, H, Ws, C)  # rows
        t = t.permute(0, 2, 1, 3).reshape(B, Ws, H * C)
        out = torch.matmul(Cm, t).reshape(B, W, H, C).permute(0, 2, 1, 3)  # columns
    # border blend where the coverage is below 1 (outside the source footprint)
    cov = R.sum(dim=2)[:, :, None] * Cm.sum(dim=2)[:, None, :]  # (B, H, W)
    out = out + (1.0 - cov)[..., None] * border[:, None, None, :]
    return ((out / 255.0 - _on(out.device, mean)) / _on(out.device, std)).contiguous()


def warp_params_for(
    src_hw: Tuple[int, int],
    out_size: Tuple[int, int],
    resize_max_side: int,
    scale: float = 1.0,
    mirror: bool = False,
):
    """Host helper: compose resize -> scale-aug -> mirror -> center-pad into
    the (sx, sy, tx, ty) device params + the matching label affine (2x3)."""
    h0, w0 = src_hw
    sw, sh = out_size
    r = resize_max_side / max(h0, w0)
    nw, nh = int(w0 * r), int(h0 * r)
    s_eff = r * scale
    off = (np.array([nw, nh], np.float64) * (1 - scale)) / 2.0
    tx, ty = off[0], off[1]
    sx = s_eff
    if mirror:
        sx = -s_eff
        tx = nw - tx
    pad_w = (sw - nw) // 2
    pad_h = (sh - nh) // 2
    tx += pad_w
    ty += pad_h
    M = np.array([[sx, 0, tx], [0, s_eff, ty]], np.float64)
    return np.array([sx, s_eff, tx, ty], np.float32), M
