"""PoseResNet backbones (CenterNet lineage), depths 18/34/50/101/152, and
the deformable ResNet-101-DCN.

Port of ``rtm3d_tpu/nn/resnet.py``; reference semantics:
models/nets/resnet.py:116-238. Stem 7x7/s2 conv + BN + ReLU, 3x3/s2
max-pool (``nn/layers.py::MaxPool``, ``nn.MaxPool2d``, pads with -inf, as
the JAX ``MaxPool`` does, ``rtm3d_tpu/nn/layers.py:583-597``, and so does
its halo exchange at the frame's edges on a band); layer1..layer4 of Basic or
Bottleneck blocks; the forward returns the feature maps of the levels
named in ``kfns`` (strides 4/8/16/32), in order.

Parameter names are torchvision's and the reference's
(``conv1``, ``bn1``, ``layerN.<i>.conv1/bn1/...``, ``downsample.0/1``), so
a torchvision ``.pth`` imports by suffix and the JAX package's variables
map key for key through ``train/checkpoint.py::state_dict_from_jax``
(``blockN`` -> ``N``, ``downsample_conv/bn`` -> ``downsample.0/1``).

``RESNET-<depth>-DCN`` (``parse_resnet_name``) is FCOS3D's trunk
(open-mmlab/mmdetection3d ``fcos3d_r101-caffe-dcn_fpn_head-gn_8xb2-1x_
nus-mono3d.py``: ``ResNet(depth=101, style='caffe', dcn=dict(type='DCNv2',
deform_groups=1, fallback_on_stride=False), stage_with_dcn=(False, False,
True, True))``): Bottlenecks in caffe style, whose stride sits on ``conv1``
(the 1x1) and not on ``conv2``, and whose ``conv2`` in ``layer3`` and
``layer4`` is a modulated deformable conv (``nn/dcn.py``), stride 1
everywhere. Its keys are the plain ResNet's, with ``conv2.conv_offset.*``
and ``conv2.conv.weight`` in place of ``conv2.weight`` there. The plain
depths keep their PyTorch-style blocks.
"""

from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from rtm3d_tpu_torch.nn.dcn import ModulatedDeformConv
from rtm3d_tpu_torch.nn.layers import BatchNorm, Conv, MaxPool, remat_segment
from rtm3d_tpu_torch.nn.spec import ShapeSpec


def _downsample(in_planes: int, out_planes: int, stride: int) -> nn.Sequential:
    return nn.Sequential(Conv(in_planes, out_planes, 1, stride, padding=0), BatchNorm(out_planes))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1, has_downsample: bool = False):
        super().__init__()
        self.conv1 = Conv(in_planes, planes, 3, stride)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv(planes, planes, 3, 1)
        self.bn2 = BatchNorm(planes)
        self.downsample = _downsample(in_planes, planes, stride) if has_downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)), inplace=True)
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual, inplace=True)


class Bottleneck(nn.Module):
    """``caffe``: the stride on ``conv1`` instead of ``conv2``; ``dcn``:
    ``conv2`` deformable (stride 1 only, so caffe style)."""

    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1, has_downsample: bool = False,
                 caffe: bool = False, dcn: bool = False):
        super().__init__()
        stride1, stride2 = (stride, 1) if caffe else (1, stride)
        if dcn and stride2 != 1:
            raise ValueError("a deformable conv2 runs at stride 1: build its block in caffe style")
        self.conv1 = Conv(in_planes, planes, 1, stride1, padding=0)
        self.bn1 = BatchNorm(planes)
        self.conv2 = ModulatedDeformConv(planes, planes) if dcn else Conv(planes, planes, 3, stride2)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv(planes, planes * 4, 1, 1, padding=0)
        self.bn3 = BatchNorm(planes * 4)
        self.downsample = _downsample(in_planes, planes * 4, stride) if has_downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)), inplace=True)
        out = F.relu(self.bn2(self.conv2(out)), inplace=True)
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual, inplace=True)


RESNET_SPEC = {
    18: (BasicBlock, [2, 2, 2, 2]),
    34: (BasicBlock, [3, 4, 6, 3]),
    50: (Bottleneck, [3, 4, 6, 3]),
    101: (Bottleneck, [3, 4, 23, 3]),
    152: (Bottleneck, [3, 8, 36, 3]),
}
_CHANNELS = [64, 128, 256, 512]
_LAYERS = ("layer1", "layer2", "layer3", "layer4")


class ResLayer(nn.Sequential):
    """``blocks`` blocks as Sequential indices 0..blocks-1; the first strides
    and, when the shape changes, projects the residual."""

    def __init__(self, block, in_planes: int, planes: int, blocks: int, stride: int = 1, **style):
        exp = block.expansion
        need_ds = stride != 1 or in_planes != planes * exp
        mods = [block(in_planes, planes, stride, need_ds, **style)]
        mods += [block(planes * exp, planes, 1, False, **style) for _ in range(1, blocks)]
        super().__init__(*mods)


def parse_resnet_name(name: str) -> tuple:
    """``(depth, dcn)`` of a backbone name: ``RESNET-18`` -> (18, False),
    ``RESNET-101-DCN`` -> (101, True); the depth is the last number."""
    name = name.upper()
    dcn = name.endswith("-DCN")
    return int((name[:-len("-DCN")] if dcn else name).split("-")[-1]), dcn


def built_layers(kfns: Sequence[str]) -> list:
    """The layers the JAX forward builds for ``kfns``: it stops at the first
    layer that is not named once as many layers as ``kfns`` has are behind
    it (``rtm3d_tpu/nn/resnet.py:115-116``), so a subset of levels decides
    which ``layerN`` (and their parameters) exist."""
    out = []
    for idx, name in enumerate(_LAYERS):
        if name not in kfns and idx >= len(kfns):
            break
        out.append(name)
    return out


class PoseResNet(nn.Module):
    """Returns the features of every level named in ``kfns`` (in order).
    ``dcn``: caffe-style Bottlenecks with deformable ``conv2`` in ``layer3``
    and ``layer4`` (the module docstring)."""

    def __init__(self, depth: int = 18, kfns: Sequence[str] = _LAYERS, dcn: bool = False):
        super().__init__()
        if depth not in RESNET_SPEC:
            raise ValueError(f"ResNet depth {depth} is not one of {sorted(RESNET_SPEC)}")
        self.depth = depth
        self.kfns = tuple(kfns)
        block, layers = RESNET_SPEC[depth]
        if dcn and block is not Bottleneck:
            raise ValueError(f"ResNet-{depth}-DCN: deformable convs sit in Bottleneck blocks (depth 50 and up)")
        self.conv1 = Conv(3, 64, 7, 2)
        self.bn1 = BatchNorm(64)
        self.maxpool = MaxPool(3, 2, 1)
        in_planes = 64
        self.layer_names = built_layers(self.kfns)
        for idx, name in enumerate(self.layer_names):
            stride = 1 if idx == 0 else 2
            style = {"caffe": True, "dcn": idx >= 2} if dcn else {}
            self.add_module(name, ResLayer(block, in_planes, _CHANNELS[idx], layers[idx], stride, **style))
            in_planes = _CHANNELS[idx] * block.expansion

    @property
    def kfpn_spec(self):
        block, _ = RESNET_SPEC[self.depth]
        return {
            k: ShapeSpec(channels=_CHANNELS[int(k[-1]) - 1] * block.expansion, stride=2 ** (int(k[-1]) + 1))
            for k in self.kfns
        }

    def forward(self, x, remat: bool = False):
        """With ``remat`` (training) each of ``layer1..layer4`` is a
        checkpointed segment (``remat_segment``); the stem is not."""
        x = self.maxpool(F.relu(self.bn1(self.conv1(x)), inplace=True))
        outs = []
        for name in self.layer_names:
            x = remat_segment(getattr(self, name), remat, x)
            if name in self.kfns:
                outs.append(x)
        return outs
