"""DLA-34 backbone (Deep Layer Aggregation).

Port of ``rtm3d_tpu/nn/dla.py`` (plain branch, ``:223-234``); reference
semantics: models/nets/dla.py:13-332. Levels [1,1,1,2,2,1], channels
[16,32,64,128,256,512], BasicBlock, stride-1 7x7 stem, recursive Tree/Root
HDA nodes with MaxPool downsample and 1x1 projection on channel change.

Quirk preserved: ``level1`` is built with ``levels[0]`` convs, exactly as the
reference does (dla.py:275-279 passes ``num_convs=levels[0]``).

The space-to-depth stem of the JAX package is train-only there and is not
ported: the port always runs this plain branch.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from rtm3d_tpu_torch.nn.layers import BatchNorm, Conv, ConvBNReLU, ConvLevel
from rtm3d_tpu_torch.nn.spec import ShapeSpec

DLA34_LEVELS = [1, 1, 1, 2, 2, 1]
DLA34_CHANNELS = [16, 32, 64, 128, 256, 512]


class BasicBlock(nn.Module):
    """Two 3x3 convs + BN with an externally supplied residual
    (reference: dla.py:56-100)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        self.conv1 = Conv(in_channels, out_channels, 3, stride, dilation)
        self.norm1 = BatchNorm(out_channels)
        self.conv2 = Conv(out_channels, out_channels, 3, 1, dilation)
        self.norm2 = BatchNorm(out_channels)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        out = F.relu(self.norm1(self.conv1(x)), inplace=True)
        out = self.norm2(self.conv2(out))
        return F.relu(out + residual, inplace=True)


class Root(nn.Module):
    """1x1-conv aggregation over concatenated children
    (reference: dla.py:213-241)."""

    def __init__(self, in_channels: int, out_channels: int, residual: bool = False):
        super().__init__()
        self.conv = Conv(in_channels, out_channels, 1, padding=0)
        self.norm = BatchNorm(out_channels)
        self.residual = residual

    def forward(self, *children):
        x = self.norm(self.conv(torch.cat(children, 1)))
        if self.residual:
            x = x + children[0]
        return F.relu(x, inplace=True)


class Tree(nn.Module):
    """Recursive HDA node (reference: dla.py:103-210)."""

    def __init__(
        self,
        level: int,
        in_channels: int,
        out_channels: int,
        stride: int = 1,
        level_root: bool = False,
        root_dim: int = 0,
        root_residual: bool = False,
    ):
        super().__init__()
        if root_dim == 0:
            root_dim = 2 * out_channels
        if level_root:
            root_dim += in_channels
        if level == 1:
            self.tree1 = BasicBlock(in_channels, out_channels, stride)
            self.tree2 = BasicBlock(out_channels, out_channels, 1)
            self.root = Root(root_dim, out_channels, root_residual)
        else:
            self.tree1 = Tree(
                level - 1, in_channels, out_channels, stride,
                root_dim=0, root_residual=root_residual,
            )
            self.tree2 = Tree(
                level - 1, out_channels, out_channels,
                root_dim=root_dim + out_channels, root_residual=root_residual,
            )
        self.level = level
        self.level_root = level_root
        self.downsample = nn.MaxPool2d(stride, stride) if stride > 1 else None
        self.project = (
            nn.Sequential(Conv(in_channels, out_channels, 1, padding=0), BatchNorm(out_channels))
            if in_channels != out_channels
            else None
        )

    def forward(self, x, children=None):
        children = [] if children is None else children
        bottom = self.downsample(x) if self.downsample is not None else x
        if self.level_root:
            children.append(bottom)
        if self.level == 1:
            residual = self.project(bottom) if self.project is not None else bottom
            x1 = self.tree1(x, residual)
            x2 = self.tree2(x1)
            return self.root(x2, x1, *children)
        # above level 1 the projected residual is dead: tree1 is a Tree and
        # computes its own (the reference and the JAX package compute and
        # drop it; the weights stay, so checkpoints load unchanged). In train
        # mode its BN still folds the batch into its running statistics
        # there, so it runs for that alone, without a graph.
        if self.training and self.project is not None:
            with torch.no_grad():
                self.project(bottom)
        x1 = self.tree1(x)
        children.append(x1)
        return self.tree2(x1, children=children)


class DLABase(nn.Module):
    """DLA backbone; returns the features of the levels in ``kfns``
    (reference: dla.py:244-332)."""

    def __init__(
        self,
        kfns: Sequence[str] = ("level2", "level3", "level4", "level5"),
        levels: Sequence[int] = tuple(DLA34_LEVELS),
        channels: Sequence[int] = tuple(DLA34_CHANNELS),
        residual_root: bool = False,
    ):
        super().__init__()
        self.kfns = tuple(kfns)
        self.channels = tuple(channels)
        ch = self.channels
        self.base_layer = ConvBNReLU(3, ch[0], 7)
        self.level0 = ConvLevel(ch[0], ch[0], 3, levels[0])
        # quirk parity: level1 uses levels[0] convs (dla.py:275-279)
        self.level1 = ConvLevel(ch[0], ch[1], 3, levels[0], stride=2)
        tree_args = [
            # (level, in_ch, out_ch, level_root)
            (levels[2], ch[1], ch[2], False),
            (levels[3], ch[2], ch[3], True),
            (levels[4], ch[3], ch[4], True),
            (levels[5], ch[4], ch[5], True),
        ]
        for idx, (lvl, cin, cout, lroot) in enumerate(tree_args, start=2):
            self.add_module(
                f"level{idx}",
                Tree(lvl, cin, cout, stride=2, level_root=lroot, root_residual=residual_root),
            )

    @property
    def kfpn_spec(self):
        return {
            k: ShapeSpec(channels=self.channels[int(k[-1])], stride=2 ** int(k[-1]))
            for k in self.kfns
        }

    def forward(self, x):
        outs = []
        x = self.base_layer(x)
        for i in range(6):
            x = getattr(self, f"level{i}")(x)
            if f"level{i}" in self.kfns:
                outs.append(x)
        return outs
