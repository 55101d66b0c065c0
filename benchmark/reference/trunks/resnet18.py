"""ResNet-18 trunk in torchvision's layout, no fc or avgpool (reference:
models/nets/resnet.py:116-238), returning layer1..layer4's maps. Parameter
names are the port's, key for key."""

import torch.nn as nn

from benchmark.reference.layers import EPS

CHANNELS = (64, 128, 256, 512)


class BasicBlock(nn.Module):
    def __init__(self, inp, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = nn.Conv2d(inp, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes, eps=EPS)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes, eps=EPS)
        self.downsample = downsample

    def forward(self, x):
        r = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        return self.relu(self.bn2(self.conv2(out)) + r)


class ResNet18(nn.Module):
    def __init__(self):
        super().__init__()
        self.inplanes = 64
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=EPS)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        self.layer1 = self._make(64, 1)
        self.layer2 = self._make(128, 2)
        self.layer3 = self._make(256, 2)
        self.layer4 = self._make(512, 2)

    def _make(self, planes, stride):
        ds = None
        if stride != 1 or self.inplanes != planes:
            ds = nn.Sequential(nn.Conv2d(self.inplanes, planes, 1, stride, bias=False),
                               nn.BatchNorm2d(planes, eps=EPS))
        layers = [BasicBlock(self.inplanes, planes, stride, ds), BasicBlock(planes, planes)]
        self.inplanes = planes
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        outs = []
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
            outs.append(x)
        return outs


def build() -> nn.Module:
    return ResNet18()
