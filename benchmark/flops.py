"""The network's work, counted by the benchmark, whatever kernels run it.

``torch.utils.flop_counter.FlopCounterMode`` over the reference network of
a configuration on the meta device (no memory, no arithmetic): two
operations per multiply-add of every convolution, transposed convolution
and matrix product, at every kernel tap of every output. Forward alone for
detection; forward and backward for training (the gradients of every
parameter and of every activation but the frames'), recompute not counted.
The count includes the projected residual that DLA-34's level-2 Trees
compute and drop (0.25 GFLOP an image at 1280x416, 0.06%), as the
reference network computes it.

Peaks (NVIDIA's H100 SXM data sheet, dense, at the full 700 W power
limit): the rate of the tensor cores in the configuration's compute dtype.
"""

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference.network import build_network

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # float32: the CUDA cores; TF32 is off


def flops_per_image(conf: dict, hw, backward: bool) -> float:
    """Operations of one image of ``hw`` (H, W) through the network."""
    with torch.device("meta"):
        net = build_network(conf)
    net.train(backward)
    x = torch.empty((1, 3, *hw), device="meta")
    with FlopCounterMode(display=False) as counter:
        if backward:
            sum(o.sum() for o in net(x)).backward()
        else:
            with torch.no_grad():
                net(x)
    return float(counter.get_total_flops())
