"""The RTM3D network in plain ``torch.nn``: a trunk, the keypoint FPN fusion
and the four-branch header (reference: models/model.py:9-27,
keypoint_fpn_fusion.py:18-69, header.py:6-46).

The trunk is ``reference/trunks/<name>.py`` (its ``build()`` and
``CHANNELS``), named by the configuration's file, so a configuration with
another trunk adds a file. Parameter names are the port's, key for key, so
one state dict loads strict into both.
"""

import importlib

import torch
import torch.nn as nn

from benchmark.reference.layers import make_conv_level

BRANCHES = (("main_kf", None), ("offset_fr_main", 16), ("main_offset", 2), ("vertex_offset", 2))


class TUpSample(nn.Module):
    def __init__(self, c, k=2):
        super().__init__()
        self.conv_tran = nn.ConvTranspose2d(c, c, k * 2, stride=k, padding=k // 2, bias=False)

    def forward(self, x):
        return self.conv_tran(x)


class TKFPN(nn.Module):
    """Top-down FPN, then every level upsampled to stride 4 and added under
    a detached per-channel softmax over H x W (kfpn:62-68)."""

    def __init__(self, chans, out_ch=256, levels=(2, 3, 4, 5)):
        super().__init__()
        self.levels = levels
        lv = levels
        for i in range(len(lv) - 1, 0, -1):
            setattr(self, f"kfpn_head{lv[i]}", nn.Conv2d(chans[i], out_ch, 1, 1, bias=True))
            setattr(self, f"kfpn_up{lv[i]}", TUpSample(out_ch))
            setattr(self, f"kfpn_proj{lv[i]}", nn.Conv2d(chans[i - 1] + out_ch, chans[i - 1], 1, 1, bias=True))
        setattr(self, f"kfpn_head{lv[0]}", nn.Conv2d(chans[0], out_ch, 1, 1, bias=True))
        for i in range(len(lv) - 1, 0, -1):
            setattr(self, f"fusion_up{lv[i]}", nn.Sequential(*[TUpSample(out_ch) for _ in range(lv[i] - lv[0])]))

    def forward(self, x):
        lv = self.levels
        x = list(x)
        for i in range(len(lv) - 1, 0, -1):
            x[i] = getattr(self, f"kfpn_head{lv[i]}")(x[i])
            up = getattr(self, f"kfpn_up{lv[i]}")(x[i])
            x[i - 1] = getattr(self, f"kfpn_proj{lv[i]}")(torch.cat([up, x[i - 1]], 1))
        z = getattr(self, f"kfpn_head{lv[0]}")(x[0])
        for i in range(len(lv) - 1, 0, -1):
            o = getattr(self, f"fusion_up{lv[i]}")(x[i])
            b, c, h, w = o.shape
            att = torch.softmax(o.detach().reshape(b, c, h * w), dim=-1).reshape(b, c, h, w)
            z = z + o * att
        return z


class THeader(nn.Module):
    def __init__(self, in_ch=256, num_cls=3, num_conv=2):
        super().__init__()
        dil = [6] + [1] * (num_conv - 1)
        for name, out in BRANCHES:
            seq = make_conv_level(in_ch, in_ch, 3, num_conv, bias=True, dilation=dil)
            seq.add_module(f"{name}_head", nn.Conv2d(in_ch, out or num_cls, 3, padding=1, bias=True))
            setattr(self, f"{name}_header", seq)

    def forward(self, x):
        return tuple(getattr(self, f"{name}_header")(x) for name, _ in BRANCHES)


class TModel(nn.Module):
    def __init__(self, trunk, chans, num_cls=3, out_ch=256, num_conv=2):
        super().__init__()
        self.backbone = trunk
        self.kfpn_fusion = TKFPN(chans, out_ch)
        self.detect_header = THeader(out_ch, num_cls, num_conv)

    def forward(self, x):
        return self.detect_header(self.kfpn_fusion(self.backbone(x)))


def build_network(conf: dict) -> nn.Module:
    """The network of a configuration file's dict (``reference_trunk``,
    ``config.MODEL``, ``config.DATASET.OBJs``), on the current default
    device, with torch's default init (the caller loads its weights)."""
    trunk = importlib.import_module(f"benchmark.reference.trunks.{conf['reference_trunk']}")
    model = conf["config"]["MODEL"]
    net = TModel(trunk.build(), trunk.CHANNELS, num_cls=len(conf["config"]["DATASET"]["OBJs"]),
                 out_ch=int(model["OUT_CHANNELS"]), num_conv=int(model["HEADER_NUM_CONV"]))
    for m in net.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.momentum = 0.03  # the reference's initialize_weights
    return net
