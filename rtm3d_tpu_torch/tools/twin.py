"""The torch twin: the reference network restated in plain ``torch.nn``.

The port's copy of ``tools/ap_parity.py::build_torch_twin`` (:65-96) and
of the classes it builds from: for DLA-34 ``tests/test_model_parity.py``
(:24-209: ``make_conv_level``, ``TBasic``, ``TRoot``, ``TTree``, ``TDLA``,
``TUpSample``, ``TKFPN``, ``THeader``), for ResNet-18
``tests/test_checkpoint.py::_torch_resnet18`` (:128-186, a
torchvision-layout trunk). They are written from the reference's modules
(models/nets/dla.py, resnet.py, keypoint_fpn_fusion.py, header.py and
torch_utils.make_conv_level), not from the port's ``nn/``: the
side-by-side mode of ``tools/ap_parity.py`` trains this network with the
reference's training semantics (``tools/reference_train.py``) beside the
port.

The classes are copied construction step for construction step: under
``torch.manual_seed(seed)`` each module draws its default init (torch's
``kaiming_uniform_`` for conv and transposed-conv weights, the uniform
bias) from the global CPU generator in construction order, so the same
order gives the JAX tool's init bit for bit. BatchNorm eps is 1e-4 and
momentum 0.03 (the reference's ``initialize_weights``,
torch_utils.py:79-81). ``build_torch_twin`` restores the global generator
after the draw (the JAX tool leaves it seeded).

The twin's parameter names are the port model's, key for key, so its
state dict loads strict into ``nn/model.py::create_model``'s network
(``load_twin``). ``state_dict_sha256`` fingerprints a draw, so that a run
on another torch build can show it drew the same init.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch
import torch.nn as nn

EPS = 1e-4
BACKBONES = ("RESNET-18", "DLA-34")
# state_dict_sha256 of build_torch_twin(5, backbone), taken with torch 2.13 on the CPU, where it equals the JAX
# tool's twin bit for bit (tests/test_torch_side_by_side.py)
TWIN_SHA256 = {
    "RESNET-18": "3b1be960384a6d9bb996fc07eb3e0642e9aa27ffcc485c7ce1c861b8b5af0439",
    "DLA-34": "92030ec7d9c2e3907991e9f527addce218de6b38aa8c996e6158dad0ef84c49f",
}


def make_conv_level(cin, cout, k, num, bias=False, dilation=1):
    if isinstance(dilation, int):
        dilation = [dilation] * num
    chans = [cin] * (num - 1) + [cout]
    mods = []
    c = cin
    for i in range(num):
        pad = (k - 1) * dilation[i] // 2
        mods += [
            nn.Conv2d(c, chans[i], k, 1, pad, dilation=dilation[i], bias=bias),
            nn.BatchNorm2d(chans[i], eps=EPS),
            nn.ReLU(inplace=True),
        ]
        c = chans[i]
    return nn.Sequential(*mods)


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
            if cin != cout
            else None
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
            nn.Conv2d(3, ch[0], 7, 1, 3, bias=False),
            nn.BatchNorm2d(ch[0], eps=EPS),
            nn.ReLU(inplace=True),
        )
        self.level0 = make_conv_level(ch[0], ch[0], 3, 1)
        self.level1 = make_conv_level(ch[0], ch[1], 3, 1)
        # the reference passes stride 2 into make_conv_level for level1
        self.level1[0].stride = (2, 2)
        self.level2 = TTree(1, ch[1], ch[2], 2, False)
        self.level3 = TTree(2, ch[2], ch[3], 2, True)
        self.level4 = TTree(2, ch[3], ch[4], 2, True)
        self.level5 = TTree(1, ch[4], ch[5], 2, True)

    def forward(self, x):
        x = self.base_layer(x)
        x = self.level0(x)
        x = self.level1(x)
        y = []
        for name in ("level2", "level3", "level4", "level5"):
            x = getattr(self, name)(x)
            y.append(x)
        return y


class TUpSample(nn.Module):
    def __init__(self, c1, c2=None, k=2):
        super().__init__()
        c2 = c2 or c1
        self.conv_tran = nn.ConvTranspose2d(c1, c2, k * 2, stride=k, padding=k // 2, bias=False)

    def forward(self, x):
        return self.conv_tran(x)


class TKFPN(nn.Module):
    def __init__(self, chans=(64, 128, 256, 512), out_ch=256):
        super().__init__()
        levels = [2, 3, 4, 5]
        for i in range(3, 0, -1):
            setattr(self, f"kfpn_head{levels[i]}", nn.Conv2d(chans[i], out_ch, 1, 1, bias=True))
            setattr(self, f"kfpn_up{levels[i]}", TUpSample(out_ch))
            setattr(self, f"kfpn_proj{levels[i]}", nn.Conv2d(chans[i - 1] + out_ch, chans[i - 1], 1, 1, bias=True))
        setattr(self, f"kfpn_head{levels[0]}", nn.Conv2d(chans[0], out_ch, 1, 1, bias=True))
        for i in range(3, 0, -1):
            setattr(self, f"fusion_up{levels[i]}", nn.Sequential(*[TUpSample(out_ch) for _ in range(levels[i] - 2)]))

    def forward(self, x):
        levels = [2, 3, 4, 5]
        x = list(x)
        for i in range(3, 0, -1):
            x[i] = getattr(self, f"kfpn_head{levels[i]}")(x[i])
            up = getattr(self, f"kfpn_up{levels[i]}")(x[i])
            x[i - 1] = getattr(self, f"kfpn_proj{levels[i]}")(torch.cat([up, x[i - 1]], 1))
        x[0] = getattr(self, "kfpn_head2")(x[0])
        z = x[0]
        for i in range(3, 0, -1):
            o = getattr(self, f"fusion_up{levels[i]}")(x[i])
            bs, c, h, w = o.shape
            att = torch.softmax(o.detach().view(bs, c, -1), dim=-1).view(bs, c, h, w)
            z = z + o * att
        return z


class THeader(nn.Module):
    def __init__(self, in_ch=256, num_cls=3, num_conv=2):
        super().__init__()
        dil = [6] + [1] * (num_conv - 1)
        for name, out in (("main_kf", num_cls), ("offset_fr_main", 16), ("main_offset", 2), ("vertex_offset", 2)):
            seq = make_conv_level(in_ch, in_ch, 3, num_conv, bias=True, dilation=dil)
            seq.add_module(f"{name}_head", nn.Conv2d(in_ch, out, 3, padding=1, bias=True))
            setattr(self, f"{name}_header", seq)

    def forward(self, x):
        return (
            self.main_kf_header(x),
            self.offset_fr_main_header(x),
            self.main_offset_header(x),
            self.vertex_offset_header(x),
        )


def torch_resnet18(eps=EPS):
    """A torchvision-layout ResNet-18 trunk (no fc, no avgpool) returning
    layer1..layer4's maps."""

    class BasicBlock(nn.Module):
        def __init__(self, inp, planes, stride=1, downsample=None):
            super().__init__()
            self.conv1 = nn.Conv2d(inp, planes, 3, stride, 1, bias=False)
            self.bn1 = nn.BatchNorm2d(planes, eps=eps)
            self.relu = nn.ReLU(inplace=True)
            self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
            self.bn2 = nn.BatchNorm2d(planes, eps=eps)
            self.downsample = downsample

        def forward(self, x):
            r = x
            out = self.relu(self.bn1(self.conv1(x)))
            out = self.bn2(self.conv2(out))
            if self.downsample is not None:
                r = self.downsample(x)
            return self.relu(out + r)

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.inplanes = 64
            self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
            self.bn1 = nn.BatchNorm2d(64, eps=eps)
            self.relu = nn.ReLU(inplace=True)
            self.maxpool = nn.MaxPool2d(3, 2, 1)
            self.layer1 = self._make(64, 2, 1)
            self.layer2 = self._make(128, 2, 2)
            self.layer3 = self._make(256, 2, 2)
            self.layer4 = self._make(512, 2, 2)

        def _make(self, planes, blocks, stride):
            ds = None
            if stride != 1 or self.inplanes != planes:
                ds = nn.Sequential(
                    nn.Conv2d(self.inplanes, planes, 1, stride, bias=False),
                    nn.BatchNorm2d(planes, eps=eps),
                )
            layers = [BasicBlock(self.inplanes, planes, stride, ds)]
            self.inplanes = planes
            layers.append(BasicBlock(planes, planes))
            return nn.Sequential(*layers)

        def forward(self, x):
            x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
            outs = []
            for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
                x = layer(x)
                outs.append(x)
            return outs

    return Net()


class TPoseModel(nn.Module):
    def __init__(self, trunk, chans):
        super().__init__()
        self.backbone = trunk
        self.kfpn_fusion = TKFPN(chans=chans)
        self.detect_header = THeader()

    def forward(self, x):
        return self.detect_header(self.kfpn_fusion(self.backbone(x)))


def build_torch_twin(seed: int = 5, backbone: str = "RESNET-18") -> nn.Module:
    """The whole twin of ``backbone``, drawn under ``torch.manual_seed(seed)``
    in the JAX tool's construction order (the trunk, then the KFPN, then
    the header), BatchNorm momentum 0.03; on the CPU, in train mode."""
    if backbone not in BACKBONES:
        raise ValueError(f"the twin has no backbone {backbone!r}: one of {BACKBONES}")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        trunk = TDLA() if backbone == "DLA-34" else torch_resnet18()
        twin = TPoseModel(trunk, (64, 128, 256, 512))
    for mod in twin.modules():
        if isinstance(mod, nn.BatchNorm2d):
            mod.momentum = 0.03
    return twin


def load_twin(model: nn.Module, twin_state: dict) -> nn.Module:
    """``twin_state`` into the port's ``model``, strict: the names are the
    same key for key, so nothing is missed and nothing is left over."""
    model.load_state_dict({k: v.detach().to("cpu") for k, v in twin_state.items()}, strict=True)
    return model


def state_dict_sha256(state: dict) -> str:
    """SHA-256 over every tensor of ``state`` in key order: the name, the
    dtype, the shape and the bytes."""
    h = hashlib.sha256()
    for k in sorted(state):
        a = np.ascontiguousarray(state[k].detach().cpu().numpy())
        h.update(f"{k}|{a.dtype}|{a.shape}|".encode())
        h.update(a.tobytes())
    return h.hexdigest()
