"""The RTM3D model: backbone + KFPN fusion + header, and the factory.

Port of ``rtm3d_tpu/nn/model.py:26-94``; reference semantics:
models/model.py:9-27 and models/model_factory.py:23-37. The backbone is
DLA-34 (``nn/dla.py``) or a PoseResNet of the depth the name ends in
(``RESNET-18`` ... ``RESNET-152``, ``nn/resnet.py``). The forward takes
NCHW (or channels_last) images and returns the 4 logit maps in NCHW:
(main_kf [B,C,H/4,W/4], offset_fr_main [.,16,.,.], main_offset [.,2,.,.],
vertex_offset [.,2,.,.]); decode is separate (``decode/peaks.py``).

``forward(x, remat=True)`` is the training forward under ``TPU.REMAT``:
each backbone stage (DLA-34's ``base_layer`` and ``level0..level5``,
ResNet's ``layer1..layer4``), the KFPN fusion and each header branch runs
as a checkpointed segment (``nn/layers.py::remat_segment``). The JAX step
checkpoints its whole forward as one segment
(``rtm3d_tpu/train/step.py:141-142``), which XLA schedules as one program;
in eager PyTorch one segment would hold every activation again while it
recomputes, and save almost nothing. Segments a stage long keep one
stage's activations at a time; the KFPN and the header, at stride 4 and
256 channels, hold most of a DLA-34 step's activations, so they are
segments too.

Under the spatial mesh axis the train and eval-loss steps attach a
``parallel/spatial.py::Grid`` to the model for the step
(``spatial.attached``): the backbone, the KFPN and the header then run on
this rank's band of each frame's rows, with the halo exchanges of
``nn/layers.py``. ``deepest_stride`` is the unit the bands are cut in.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from rtm3d_tpu_torch.config import Config
from rtm3d_tpu_torch.nn.dla import DLABase
from rtm3d_tpu_torch.nn.header import RTM3DHeader
from rtm3d_tpu_torch.nn.kfpn import KeypointFPNFusion
from rtm3d_tpu_torch.nn.layers import init_weights, remat_segment
from rtm3d_tpu_torch.nn.resnet import PoseResNet, built_layers
from rtm3d_tpu_torch.utils.profiling import span


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

    def forward(self, x, remat: bool = False):
        with span("net.backbone"):
            feats = self.backbone(x, remat)
        with span("net.kfpn"):
            fused = remat_segment(self.kfpn_fusion, remat, feats)
        with span("net.header"):
            return self.detect_header(fused, remat)


def deepest_stride(cfg: Config) -> int:
    """The largest stride the network of ``cfg`` reaches: DLA-34 always
    runs ``level0..level5`` (32); a PoseResNet runs ``layer1`` (stride 4)
    to the last layer ``built_layers`` keeps."""
    name = str(cfg.MODEL.BACKBONE).upper()
    if "RESNET" in name:
        return 2 ** (len(built_layers(tuple(cfg.MODEL.KFNs))) + 1)
    return 32


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

