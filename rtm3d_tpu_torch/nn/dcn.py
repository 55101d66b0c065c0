"""Modulated deformable convolution (DCNv2) as a layer of the network.

``ModulatedDeformConv`` is mmcv's ``ModulatedDeformConv2dPack`` as FCOS3D's
ResNet-101-DCN uses it (``dcn=dict(type='DCNv2', deform_groups=1)``, every
3x3 conv of ``layer3`` and ``layer4``; Zhu et al., arXiv:1811.11168): a 3x3
conv, stride 1, padding 1, no bias, whose nine taps are sampled at learned
offsets and weighted by a learned mask. ``conv_offset`` (a 3x3 conv with
bias, 27 outputs) gives each output pixel's (dy_k, dx_k) at channels
(2k, 2k + 1), as mmcv orders them after ``cat(o1, o2)``, and its 9 mask
logits (channels 18..26, through a sigmoid). The 3x3 weight lives in the
child ``conv``, a ``Conv`` of stride 3 over the (3H, 3W) tap image
(``ops/dcn.py::deform_taps``), so that the benchmark's plain reference
(``benchmark/reference/dcn.py``) names the same keys and its xavier bound
is a 3x3 conv's; both are drawn by ``layers.init_weights`` (mmcv
zero-initialises the offset conv; a trained one moves taps by pixels).

The layer takes one of two paths, chosen from what the forward observes
(``nn/layers.py::kernel_may_run``, the KFPN fusion's conditions too):
- the kernel, ``ops/dcn.py::modulated_deform_conv`` (``csrc/dcn.cu``, one
  launch a layer, counted as ``dcn_kernel``), for a CUDA input with autograd
  and autocast off and no ``torch.compile`` or ``torch.export`` trace: the
  detect step and the ``Detector``. Tensors the kernel does not take raise
  there: there is no composed fallback on the card;
- composed, ``ops/dcn.py::dcn_reference`` (gathers and a stride-3 conv,
  differentiable), everywhere else: training (REMAT included), eval-loss
  under autocast, export and the CPU.
Both run under the ``net.dcn`` span with the offset conv. On a band of the
spatial mesh axis the layer raises, as a sample's offset may reach past the
band's halo; int8 serving and calibration refuse a network with this layer
(``refuse_dcn``), as the int8 path has no gathered conv.
"""

from __future__ import annotations

from torch import nn

from rtm3d_tpu_torch.nn.layers import Conv, kernel_may_run
from rtm3d_tpu_torch.ops.dcn import OFFSET_CHANNELS, dcn_reference, modulated_deform_conv
from rtm3d_tpu_torch.utils.profiling import count, span


class ModulatedDeformConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv_offset = Conv(in_channels, OFFSET_CHANNELS, 3, bias=True)
        self.conv = Conv(in_channels, out_channels, 3, stride=3, padding=0)

    def forward(self, x):
        if self.conv_offset.spatial is not None:
            raise ValueError("a deformable conv does not run on a band of the frame's rows: its samples reach "
                             "past the halo (TPU.MESH_SHAPE's spatial size must be 1 for a DCN backbone)")
        with span("net.dcn"):
            om = self.conv_offset(x)
            if kernel_may_run(x):
                count("dcn_kernel")
                return modulated_deform_conv(x, om, self.conv.weight)
            return dcn_reference(x, om, self.conv.weight)


def refuse_dcn(model: nn.Module, what: str) -> None:
    """Raise ``ValueError`` naming ``what`` when ``model`` holds a
    deformable conv."""
    if any(isinstance(m, ModulatedDeformConv) for m in model.modules()):
        raise ValueError(f"{what} does not take a network with deformable convs (a DCN backbone): "
                         "serve it in bfloat16 or float32")
