"""FCOS3D's ResNet-101-DCN trunk (open-mmlab/mmdetection3d
``configs/fcos3d/fcos3d_r101-caffe-dcn_fpn_head-gn_8xb2-1x_nus-mono3d.py``;
FCOS3D, arXiv:2104.10956): ``ResNet(depth=101, style='caffe',
norm_eval=True, dcn=dict(type='DCNv2', deform_groups=1,
fallback_on_stride=False), stage_with_dcn=(False, False, True, True))``.

torchvision's layout (stem, ``layer1..layer4`` of 3 / 4 / 23 / 3
Bottlenecks), no fc or avgpool, returning the four layers' maps (256 / 512
/ 1024 / 2048 channels at strides 4 / 8 / 16 / 32). Caffe style puts each
block's stride on its first 1x1 conv; every 3x3 conv of ``layer3`` and
``layer4`` (26) is a modulated deformable conv (``reference/dcn.py``),
stride 1. Parameter names are the port's, key for key.

Departures from the published model: random weights from the seed, the
offset convs drawn like every conv (mmcv zero-initialises them, so that an
untrained layer samples the plain 3x3 grid; trained offsets are pixels);
the BatchNorms frozen by ``norm_eval`` are served as eval-mode BatchNorm
with the reference's eps (``EPS``), which is what frozen statistics give.
"""

import torch.nn as nn

from benchmark.reference.dcn import ModulatedDeformConv
from benchmark.reference.layers import EPS

CHANNELS = (256, 512, 1024, 2048)
BLOCKS = (3, 4, 23, 3)
DCN_STAGES = (False, False, True, True)


class Bottleneck(nn.Module):
    def __init__(self, inp, planes, stride=1, downsample=None, dcn=False):
        super().__init__()
        self.conv1 = nn.Conv2d(inp, planes, 1, stride, bias=False)  # caffe style: the stride here
        self.bn1 = nn.BatchNorm2d(planes, eps=EPS)
        self.conv2 = ModulatedDeformConv(planes, planes) if dcn else nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes, eps=EPS)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4, eps=EPS)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        r = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        return self.relu(self.bn3(self.conv3(out)) + r)


class ResNet101DCN(nn.Module):
    def __init__(self):
        super().__init__()
        self.inplanes = 64
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=EPS)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        for n, (blocks, dcn) in enumerate(zip(BLOCKS, DCN_STAGES)):
            setattr(self, f"layer{n + 1}", self._make(64 * 2 ** n, blocks, 1 if n == 0 else 2, dcn))

    def _make(self, planes, blocks, stride, dcn):
        ds = None
        if stride != 1 or self.inplanes != planes * 4:
            ds = nn.Sequential(nn.Conv2d(self.inplanes, planes * 4, 1, stride, bias=False),
                               nn.BatchNorm2d(planes * 4, eps=EPS))
        layers = [Bottleneck(self.inplanes, planes, stride, ds, dcn)]
        self.inplanes = planes * 4
        layers += [Bottleneck(self.inplanes, planes, dcn=dcn) for _ in range(1, blocks)]
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        outs = []
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
            outs.append(x)
        return outs


def build() -> nn.Module:
    return ResNet101DCN()
