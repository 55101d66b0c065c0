"""The input stage, plain PyTorch: what a frame is before the network.

- ``normalize``: uint8 (B, H, W, 3) -> (x / 255 - mean) / std.
- ``warp``: a raw canvas resampled to the input size by the separable
  bilinear map ``src = (dst - t) / s`` per axis (the reader's resize, scale
  augmentation, mirror and centre pad composed: reference transforms.py
  325-369, 448-477, 480-495), sources past the frame's true size never
  read, and the per-image border colour blended in by the share of each
  output pixel the frame does not cover; then normalised.
- ``photometric``: ``x * alpha + beta * 255`` plus N(0, std) noise,
  clipped to [0, 255], the noise one draw for the batch from a
  ``torch.Generator`` on the frames' device, seeded by folding the
  batch's seed column (``h = h * 1000003 + s mod 2^63``) and scaled per
  image: the training recipe's contract for its noise stream.

The products run in float32 with TF32 off.
"""

import torch


def normalize(x: torch.Tensor, mean, std) -> torch.Tensor:
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x.float() / 255.0 - m) / s


def _axis_weights(n_out: int, n_in: int, scale, offset, n_valid) -> torch.Tensor:
    """(B, n_out, n_in): two-tap bilinear weights of each output row."""
    dev = scale.device
    src = (torch.arange(n_out, dtype=torch.float32, device=dev)[None, :, None] - offset[:, None, None]) \
        / scale[:, None, None]
    j = torch.arange(n_in, dtype=torch.float32, device=dev)[None, None, :]
    nv = n_valid[:, None, None]
    w = torch.clamp(1.0 - (src - j).abs(), min=0.0) * (j <= nv - 1)
    return w * ((src >= -0.5) & (src <= nv - 0.5))


def warp(images: torch.Tensor, params: torch.Tensor, out_hw, mean, std, border: torch.Tensor) -> torch.Tensor:
    """images (B, Hs, Ws, 3) uint8 or float; params (B, 6) sx, sy, tx, ty,
    w0, h0; border (B, 3) -> (B, H, W, 3) normalised float32."""
    H, W = out_hw
    B, Hs, Ws, C = images.shape
    x = images.float()
    sx, sy, tx, ty, w0, h0 = params.float().unbind(-1)
    R = _axis_weights(H, Hs, sy, ty, h0)
    Cm = _axis_weights(W, Ws, sx, tx, w0)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rows = torch.einsum("bhs,bswc->bhwc", R, x)
        out = torch.einsum("bvw,bhwc->bhvc", Cm, rows)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    cover = R.sum(2)[:, :, None] * Cm.sum(2)[:, None, :]
    out = out + (1.0 - cover)[..., None] * border.float()[:, None, None, :]
    m = torch.tensor(mean, dtype=torch.float32, device=out.device)
    s = torch.tensor(std, dtype=torch.float32, device=out.device)
    return (out / 255.0 - m) / s


def photometric(x: torch.Tensor, photo: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, 3) uint8; photo (B, 4) alpha, beta, std, seed."""
    ph = photo.float()
    y = x.float() * ph[:, 0, None, None, None] + ph[:, 1, None, None, None] * 255.0
    seed = 0
    for s in ph[:, 3].tolist():
        seed = (seed * 1000003 + int(s)) % (2 ** 63)
    gen = torch.Generator(device=y.device).manual_seed(seed)
    y = y + torch.randn(y.shape, generator=gen, device=y.device) * ph[:, 2, None, None, None]
    return y.clamp(0.0, 255.0)
