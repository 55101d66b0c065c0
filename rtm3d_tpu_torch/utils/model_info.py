"""Model summary: parameter count and forward FLOPs.

Port of ``rtm3d_tpu/utils/model_info.py`` (reference:
utils/torch_utils.py:118-136, ``model_info`` with optional thop GFLOPS).
The FLOPs come from ``torch.utils.flop_counter.FlopCounterMode`` over one
eval forward on the meta device (no memory, no arithmetic). It counts the
operations of convolutions, transposed convolutions and matrix products,
two per multiply-add, at every kernel tap of every output. The JAX package
reads XLA's ``cost_analysis`` of the lowered program, which counts only
the taps that land inside the (unpadded, undilated) input, and adds one
operation per element of elementwise work (BatchNorm, ReLU, the residual
adds, the KFPN softmax). The padding taps weigh more than the elementwise
work, so XLA's count is the smaller, and the more so the smaller the maps:
0.77 of this one for RTM3D ResNet-18 or DLA-34 at 64x64, 0.89 at 96x320
(a 3x3 conv on a 16x16 map: 17.33 against 18.87 MFLOP).
``tests/test_torch_tools.py`` holds the ratio.
Parameter counts are equal (the JAX count is of ``params`` alone, the
port's of ``parameters()``: BN statistics are buffers).
"""

from __future__ import annotations

import copy

import torch
from torch.utils.flop_counter import FlopCounterMode


def num_parameters(model: torch.nn.Module) -> int:
    """Reference: model_factory.get_num_parameters (model_factory.py:40-47)."""
    return sum(p.numel() for p in model.parameters())


def model_info(model: torch.nn.Module, input_hw, batch: int = 1, verbose: bool = False) -> dict:
    h, w = input_hw
    n_params = num_parameters(model)
    net = copy.deepcopy(model).to("meta").eval()
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        net(torch.empty((batch, 3, h, w), device="meta"))
    flops = float(counter.get_total_flops())
    info = {
        "params": n_params,
        "params_M": round(n_params / 1e6, 2),
        "flops": flops,
        "gflops_per_image": round(flops / 1e9 / max(batch, 1), 2),
        "input": f"{batch}x{h}x{w}x3",
    }
    if verbose:
        for name, p in model.named_parameters():
            print(f"{name:70s} {tuple(p.shape)}")
    return info
