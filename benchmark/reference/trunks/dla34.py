"""DLA-34 trunk (reference: models/nets/dla.py:13-332), levels [1,1,1,2,2,1],
channels [16,32,64,128,256,512]. Parameter names are the port's, key for key.
Above level 1 a Tree computes its projected residual and drops it, as the
reference does; those weights get no gradient."""

import torch
import torch.nn as nn

from benchmark.reference.layers import EPS, make_conv_level

CHANNELS = (64, 128, 256, 512)  # levels 2..5, the maps the KFPN takes


class TBasic(nn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.norm1 = nn.BatchNorm2d(cout, eps=EPS)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.norm2 = nn.BatchNorm2d(cout, eps=EPS)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        out = self.relu(self.norm1(self.conv1(x)))
        out = self.norm2(self.conv2(out))
        return self.relu(out + residual)


class TRoot(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1, 1, bias=False)
        self.norm = nn.BatchNorm2d(cout, eps=EPS)
        self.relu = nn.ReLU(inplace=True)

    def forward(self, *x):
        return self.relu(self.norm(self.conv(torch.cat(x, 1))))


class TTree(nn.Module):
    def __init__(self, level, cin, cout, stride=1, level_root=False, root_dim=0):
        super().__init__()
        if root_dim == 0:
            root_dim = 2 * cout
        if level_root:
            root_dim += cin
        if level == 1:
            self.tree1 = TBasic(cin, cout, stride)
            self.tree2 = TBasic(cout, cout, 1)
            self.root = TRoot(root_dim, cout)
        else:
            self.tree1 = TTree(level - 1, cin, cout, stride, root_dim=0)
            self.tree2 = TTree(level - 1, cout, cout, root_dim=root_dim + cout)
        self.level = level
        self.level_root = level_root
        self.downsample = nn.MaxPool2d(stride, stride=stride) if stride > 1 else None
        self.project = (
            nn.Sequential(nn.Conv2d(cin, cout, 1, 1, bias=False), nn.BatchNorm2d(cout, eps=EPS))
            if cin != cout else None
        )

    def forward(self, x, residual=None, children=None):
        children = [] if children is None else children
        bottom = self.downsample(x) if self.downsample else x
        residual = self.project(bottom) if self.project else bottom
        if self.level_root:
            children.append(bottom)
        x1 = self.tree1(x, residual)
        if self.level == 1:
            x2 = self.tree2(x1)
            return self.root(x2, x1, *children)
        children.append(x1)
        return self.tree2(x1, children=children)


class TDLA(nn.Module):
    def __init__(self):
        super().__init__()
        ch = [16, 32, 64, 128, 256, 512]
        self.base_layer = nn.Sequential(
            nn.Conv2d(3, ch[0], 7, 1, 3, bias=False), nn.BatchNorm2d(ch[0], eps=EPS), nn.ReLU(inplace=True))
        self.level0 = make_conv_level(ch[0], ch[0], 3, 1)
        self.level1 = make_conv_level(ch[0], ch[1], 3, 1)
        self.level1[0].stride = (2, 2)  # the reference passes stride 2 into make_conv_level
        self.level2 = TTree(1, ch[1], ch[2], 2, False)
        self.level3 = TTree(2, ch[2], ch[3], 2, True)
        self.level4 = TTree(2, ch[3], ch[4], 2, True)
        self.level5 = TTree(1, ch[4], ch[5], 2, True)

    def forward(self, x):
        x = self.level1(self.level0(self.base_layer(x)))
        y = []
        for name in ("level2", "level3", "level4", "level5"):
            x = getattr(self, name)(x)
            y.append(x)
        return y


def build() -> nn.Module:
    return TDLA()
