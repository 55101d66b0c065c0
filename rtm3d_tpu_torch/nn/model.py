"""The RTM3D model: backbone + KFPN fusion + header, and the factory.

Port of ``rtm3d_tpu/nn/model.py:26-94``; reference semantics:
models/model.py:9-27 and models/model_factory.py:23-37. The backbone is
DLA-34 (``nn/dla.py``) or a PoseResNet of the depth the name ends in
(``RESNET-18`` ... ``RESNET-152``, ``nn/resnet.py``). The forward takes
NCHW (or channels_last) images and returns the 4 logit maps in NCHW:
(main_kf [B,C,H/4,W/4], offset_fr_main [.,16,.,.], main_offset [.,2,.,.],
vertex_offset [.,2,.,.]); decode is separate (``decode/peaks.py``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from rtm3d_tpu_torch.config import Config
from rtm3d_tpu_torch.nn.dla import DLABase
from rtm3d_tpu_torch.nn.header import RTM3DHeader
from rtm3d_tpu_torch.nn.kfpn import KeypointFPNFusion
from rtm3d_tpu_torch.nn.layers import init_weights
from rtm3d_tpu_torch.nn.resnet import PoseResNet


class RTM3D(nn.Module):
    def __init__(
        self,
        backbone_name: str = "DLA-34",
        kfns: Sequence[str] = ("level2", "level3", "level4", "level5"),
        num_classes: int = 3,
        out_channels: int = 256,
        header_num_conv: int = 2,
    ):
        super().__init__()
        name = backbone_name.upper()
        if "DLA-34" in name:
            self.backbone = DLABase(kfns=tuple(kfns))
        elif "RESNET" in name:
            self.backbone = PoseResNet(depth=int(name.split("-")[-1]), kfns=tuple(kfns))
        else:
            raise ValueError(f"unsupported backbone: {backbone_name}")
        self.kfpn_fusion = KeypointFPNFusion(
            tuple(kfns), self.backbone.kfpn_spec, out_channels=out_channels
        )
        self.detect_header = RTM3DHeader(
            in_channels=out_channels,
            num_classes=num_classes,
            mid_channels=out_channels,
            num_conv=header_num_conv,
        )

    def forward(self, x):
        return self.detect_header(self.kfpn_fusion(self.backbone(x)))


def create_model(cfg: Config, generator: torch.Generator | None = None) -> RTM3D:
    """Factory mirroring model_factory.create_model (model_factory.py:23-37).
    Weights are drawn from ``generator`` (a fresh one seeded 0 when None);
    torch's global RNG is left as it was."""
    with torch.random.fork_rng(devices=[]):
        model = RTM3D(
            backbone_name=cfg.MODEL.BACKBONE,
            kfns=tuple(cfg.MODEL.KFNs),
            num_classes=len(cfg.DATASET.OBJs),
            out_channels=cfg.MODEL.OUT_CHANNELS,
            header_num_conv=cfg.MODEL.HEADER_NUM_CONV,
        )
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return init_weights(model, generator)

