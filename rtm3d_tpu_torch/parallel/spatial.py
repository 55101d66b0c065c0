"""The ``spatial`` mesh axis: each frame's rows split in bands across ranks.

Port of the JAX package's ``spatial`` axis (``rtm3d_tpu/parallel/mesh.py:
11-14, 87-94``): there XLA partitions the convolutions over the frame's
height and inserts the halo exchanges; here they are explicit. The ``S``
ranks of one data group (``parallel/dist.py``) hold the same frames, rank
``s`` the rows of band ``s`` of each, and the network runs on its band:

- ``band_rows``: bands start at multiples of the network's deepest stride
  (32 for DLA-34 and ResNet-18), so that every level's band boundary falls
  on a whole row, and are as equal as possible (416 rows at ``S = 2``:
  224 + 192).
- ``halo_exchange``: a convolution's or pool's band is its input band plus
  ``top`` rows of the band above and ``bottom`` rows of the band below
  (``halo_rows``), and the op's own pad value (0 for a conv, -inf for a
  max-pool) only at the frame's true top and bottom edges. The backward
  sends the halo rows' gradients back to their owners, which add them.
- ``softmax_hw``: a softmax over H x W per channel, across the bands (the
  KFPN's fusion, ``nn/kfpn.py``): one all-reduce MAX of each channel's max,
  one all-reduce SUM of its exponentials.

Transport: one ``all_reduce`` (sum) over the spatial group of a zeroed
``(S, n)`` buffer in which each rank fills its own slot with the rows its
neighbours need; every rank then reads its neighbours' slots. The sum of a
value and zeros is the value, so the exchange is exact. ``all_reduce`` is
the one collective that gloo takes on CUDA tensors on the card (two ranks
sharing one card must use gloo), as well as NCCL. A transport that fails
raises; there is no other.

The network takes this path only while a ``Grid`` is attached to it
(``attached``, which the train and eval-loss steps use when the spatial
axis has more than one rank); with none, every op runs as it always did.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from rtm3d_tpu_torch.parallel import dist as pdist


def band_rows(height: int, size: int, unit: int) -> list:
    """The ``(start, stop)`` rows of each of ``size`` bands of a frame of
    ``height`` rows: whole multiples of ``unit`` (the network's deepest
    stride), as equal as possible, the larger first. Raises
    ``ValueError`` when ``height`` is not a multiple of ``unit`` or a band
    would be thinner than it."""
    if height % unit:
        raise ValueError(f"the frame's {height} rows are not a multiple of the network's deepest stride {unit}, "
                         "so its bands cannot end on whole rows of every level")
    units = height // unit
    if units < size:
        raise ValueError(f"the frame's {height} rows make {units} band(s) of the network's deepest stride {unit}, "
                         f"fewer than the {size} ranks of the spatial axis: a band would be thinner than the stride")
    q, r = divmod(units, size)
    out, start = [], 0
    for i in range(size):
        stop = start + (q + (i < r)) * unit
        out.append((start, stop))
        start = stop
    return out


def halo_rows(kernel: int, stride: int, dilation: int, padding: int) -> tuple:
    """``(top, bottom)``: the rows a band's op with this kernel, stride,
    dilation and (top) padding reads above and below its input band, when
    the band starts on a multiple of the stride and the output row ``o``
    belongs to the band that holds input row ``stride * o``."""
    return padding, max(0, dilation * (kernel - 1) - padding - stride + 1)


class Grid:
    """This rank's place on the spatial axis: the bands of the frame (rows
    at the input's resolution), this rank's index among them and the
    process group of the data group."""

    def __init__(self, bands, index: int, group=None):
        self.bands = tuple((int(a), int(b)) for a, b in bands)
        self.index = int(index)
        self.group = group

    @property
    def size(self) -> int:
        return len(self.bands)

    @property
    def band(self) -> tuple:
        """This rank's ``(start, stop)`` rows at the input's resolution."""
        return self.bands[self.index]

    def level_rows(self, rows: int) -> list:
        """Every band's rows at the level where this rank's band has
        ``rows`` rows (the level's stride is this band's input rows over
        ``rows``, and must divide every band)."""
        a, b = self.band
        if rows <= 0 or (b - a) % rows:
            raise ValueError(f"a band of {rows} rows is not a level of the input band of {b - a} rows")
        stride = (b - a) // rows
        if any((hi - lo) % stride for lo, hi in self.bands):
            raise ValueError(f"the bands {self.bands} do not all divide by the level's stride {stride}")
        return [(hi - lo) // stride for lo, hi in self.bands]

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        dist.all_reduce(t, op=op, group=self.group)
        return t

    def exchange(self, up: torch.Tensor, down: torch.Tensor) -> tuple:
        """Send ``up`` to the band above and ``down`` to the band below;
        returns (the ``down`` of the band above, the ``up`` of the band
        below), None at the frame's edges. Every rank's pieces have the
        shapes of this rank's. One all-reduce over the spatial group."""
        s, n_up = self.index, up.numel()
        buf = up.new_zeros(self.size, n_up + down.numel())
        buf[s, :n_up] = up.reshape(-1)
        buf[s, n_up:] = down.reshape(-1)
        self.all_reduce(buf)
        halo_exchange.collectives += 1
        halo_exchange.bytes += buf.numel() * buf.element_size()
        above = buf[s - 1, n_up:].view(down.shape) if s > 0 else None
        below = buf[s + 1, :n_up].view(up.shape) if s < self.size - 1 else None
        return above, below


def frame_grid(height: int, unit: int) -> Grid | None:
    """The grid of a frame of ``height`` rows on this rank's spatial axis
    (``parallel/dist.py``), bands in multiples of ``unit``; None when the
    axis has one rank."""
    size = pdist.spatial_size()
    if size == 1:
        return None
    return Grid(band_rows(height, size, unit), pdist.spatial_index(), pdist.spatial_group())


@contextlib.contextmanager
def attached(model: torch.nn.Module, grid: Grid | None):
    """``model``'s banded ops (those with a ``spatial`` attribute: ``Conv``,
    ``UpSample``, ``MaxPool``, the KFPN fusion, the header) run on
    ``grid``'s bands for the block; with ``grid`` None, nothing changes."""
    if grid is None:
        yield model
        return
    mods = [m for m in model.modules() if hasattr(m, "spatial")]
    for m in mods:
        m.spatial = grid
    try:
        yield model
    finally:
        for m in mods:
            m.spatial = None


def _like(t: torch.Tensor) -> dict:
    """``t``'s dtype, device and memory format (channels_last or not)."""
    fmt = torch.channels_last if t.is_contiguous(memory_format=torch.channels_last) else torch.contiguous_format
    return {"dtype": t.dtype, "device": t.device, "memory_format": fmt}


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, top: int, bottom: int, pad: float, grid: Grid):
        B, C, h, W = x.shape
        rows = grid.level_rows(h)
        for s in range(grid.size - 1):
            if top > rows[s] or bottom > rows[s + 1]:
                raise ValueError(f"a halo of {top} rows above and {bottom} below is taller than a neighbour's band "
                                 f"(bands of {rows} rows at this level)")
        ctx.grid, ctx.top, ctx.bottom = grid, top, bottom
        above, below = grid.exchange(x[:, :, :bottom], x[:, :, h - top:])
        out = torch.empty((B, C, top + h + bottom, W), **_like(x))
        out[:, :, top:top + h] = x
        out[:, :, :top] = pad if above is None else above
        out[:, :, top + h:] = pad if below is None else below
        return out

    @staticmethod
    def backward(ctx, g):
        top, bottom = ctx.top, ctx.bottom
        h = g.shape[2] - top - bottom
        # the gradients of the band above's last `top` rows and of the band
        # below's first `bottom` rows go back to them
        from_above, from_below = ctx.grid.exchange(g[:, :, :top], g[:, :, top + h:])
        dx = torch.empty(g.shape[:2] + (h,) + g.shape[3:], **_like(g))
        dx.copy_(g[:, :, top:top + h])
        if from_above is not None:
            dx[:, :, :bottom] += from_above
        if from_below is not None:
            dx[:, :, h - top:] += from_below
        return dx, None, None, None, None


def halo_exchange(x: torch.Tensor, top: int, bottom: int, pad: float, grid: Grid) -> torch.Tensor:
    """(B, C, h, W) band -> (B, C, top + h + bottom, W): ``top`` rows of
    the band above, the band, ``bottom`` rows of the band below; ``pad``
    rows at the frame's top and bottom edges. Differentiable: the halo
    rows' gradients are added to their owners'. Raises ``ValueError``
    when a halo is taller than the band it comes from. Counts its
    collectives and their bytes, forward and backward, in
    ``halo_exchange.collectives`` and ``halo_exchange.bytes``."""
    if top == 0 and bottom == 0:
        return x
    return _HaloExchange.apply(x, top, bottom, float(pad), grid)


halo_exchange.collectives = 0
halo_exchange.bytes = 0


def softmax_hw(flat: torch.Tensor, grid: Grid) -> torch.Tensor:
    """The softmax over the last dim of ``flat`` (B, C, band pixels) taken
    over the whole frame: each band's pixels against every band's. In
    float32 at least (as autocast runs a softmax). No gradient: the KFPN
    softmaxes a detached map."""
    x = flat.detach().to(torch.promote_types(flat.dtype, torch.float32))
    m = grid.all_reduce(x.amax(-1, keepdim=True), dist.ReduceOp.MAX)
    e = torch.exp(x - m)
    return e / grid.all_reduce(e.sum(-1, keepdim=True))
