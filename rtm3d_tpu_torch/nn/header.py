"""RTM3D multi-branch detection header.

Port of ``rtm3d_tpu/nn/header.py:42-83`` (unfused path); reference
semantics: models/nets/header.py:6-46. Four parallel branches off the fused
stride-4 map, each HEADER_NUM_CONV conv-BN-ReLU (the first conv has dilation
6, padding 6) followed by a 3x3 output conv with bias:
  main_kf        -> num_classes heatmap logits
  offset_fr_main -> 16 = 8 vertices x (dx, dy)
  main_offset    -> 2 (sub-pixel center offset)
  vertex_offset  -> 2 (sub-pixel vertex offset)

Each branch is one ``nn.Sequential`` named ``<branch>_header`` whose last
child is ``<branch>_head``, the reference's layout. The JAX package's fused
first conv (``FUSE_HEADER_FIRST``, off by default) is an exact
reparameterisation for the TPU and is not ported.

On a band of the frame's rows (the spatial mesh axis) the dilation-6 conv
takes six halo rows each side and the 3x3 out conv one (``nn/layers.py::
Conv``). The four branches' first convs read the same input, so the
header exchanges its halo once for the four (``haloed_input``): the
largest exchange of a DLA-34 step, 12 rows of 256 channels at stride 4.
"""

from __future__ import annotations

from torch import nn

from rtm3d_tpu_torch.nn.layers import Conv, ConvLevel, autocast_input, remat_segment
from rtm3d_tpu_torch.parallel.spatial import halo_exchange

BRANCHES = ("main_kf", "offset_fr_main", "main_offset", "vertex_offset")


class HeadBranch(nn.Sequential):
    def __init__(self, name: str, in_channels: int, mid_channels: int, out_channels: int, num_conv: int = 2):
        dilation = [6] + [1] * (num_conv - 1)
        super().__init__(
            *ConvLevel(in_channels, mid_channels, 3, num_conv, dilation=dilation, bias=True)
        )
        self.add_module(f"{name}_head", Conv(mid_channels, out_channels, 3, bias=True))
        self[0].haloed_input = True  # on a band the header hands it its input haloed


class RTM3DHeader(nn.Module):
    spatial = None  # the grid of this rank's band (parallel/spatial.py), or None

    def __init__(self, in_channels: int = 256, num_classes: int = 3, mid_channels: int = 256, num_conv: int = 2):
        super().__init__()
        outs = (num_classes, 16, 2, 2)
        for name, oc in zip(BRANCHES, outs):
            self.add_module(
                f"{name}_header", HeadBranch(name, in_channels, mid_channels, oc, num_conv)
            )

    def forward(self, x, remat: bool = False):
        """With ``remat`` (training) each branch is a checkpointed segment.
        On a band, the branches' first convs' halo is exchanged here, once."""
        if self.spatial is not None:
            x = halo_exchange(autocast_input(x), *self.main_kf_header[0].halo(), 0.0, self.spatial)
        return tuple(remat_segment(getattr(self, f"{n}_header"), remat, x) for n in BRANCHES)
