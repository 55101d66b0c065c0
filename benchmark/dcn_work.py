"""The work of a configuration's deformable convolutions, counted on the
plain reference network (``reference/dcn.py``) on the meta device, whatever
kernel runs them in the program.

A DCNv2 layer of C_in -> C_out channels on a (B, H, W) map does
2 x 9 x C_in x C_out x B x H x W operations (a multiply-add of every
output, tap and input channel; the sampling's bilinear arithmetic is not
counted, as ``flops.py`` counts no elementwise work) and must move, at the
least, its input, its offset conv's 27 channels and its weight read once
and its output written once, in the configuration's compute dtype.

``dcn_roofline.detect_bulk`` reads the kernel's device seconds from the
traced slice's ``device_ops`` by the kernel's symbol (``KERNEL``), and the
configuration of the cell the run was started for from ``--workload`` on
the command line (``python3 -m benchmark.run`` and ``python3 -m
benchmark.layers`` both take it).
"""

import argparse
import sys

import torch

from benchmark.reference.dcn import ModulatedDeformConv
from benchmark.reference.network import build_network

KERNEL = "dcn_forward_kernel"  # csrc/dcn.cu's kernel, in the trace's demangled name
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def dcn_layers(conf: dict, hw) -> list:
    """One dict a deformable conv of the network of ``conf``, in forward
    order, for one image of ``hw`` (H, W): ``c_in``, ``c_out``, ``hw`` of its
    map, ``flops`` and ``bytes``."""
    with torch.device("meta"):
        net = build_network(conf)
    net.eval()
    layers = []

    def seen(module, args):
        _, c, h, w = args[0].shape
        c_out = module.conv.out_channels
        item = ITEMSIZE[conf["config"]["TPU"]["COMPUTE_DTYPE"]]
        layers.append({"c_in": c, "c_out": c_out, "hw": (h, w), "flops": 2 * 9 * c * c_out * h * w,
                       "bytes": item * (h * w * (c + 27 + c_out) + 9 * c * c_out)})

    hooks = [m.register_forward_pre_hook(seen) for m in net.modules() if isinstance(m, ModulatedDeformConv)]
    try:
        with torch.no_grad():
            net(torch.empty((1, 3, *hw), device="meta"))
    finally:
        for h in hooks:
            h.remove()
    return layers


def dcn_flops_per_image(conf: dict, hw) -> float:
    return float(sum(layer["flops"] for layer in dcn_layers(conf, hw)))


def kernel_seconds(device_ops) -> float:
    """The kernel's device seconds among the slice's ``device_ops`` (the
    ten largest, ``[name, seconds]``); 0 where it is not among them."""
    return sum(s for name, s in device_ops if KERNEL in name)


def cell_conf(argv=None):
    """The configuration of the cell named by ``--workload`` in ``argv``
    (the process's arguments when None), or None without one."""
    from benchmark.run import cell_parts

    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--workload")
    args, _ = p.parse_known_args(sys.argv[1:] if argv is None else argv)
    return cell_parts(args.workload)["conf"] if args.workload else None


def roofline_pct(rec: dict, conf: dict):
    """The DCN's counted operations in the slice at the peak rate over the
    kernel's device seconds there, in percent; None with no trace or no
    kernel among the ``device_ops``."""
    t = rec.get("trace")
    if not t or conf is None or not t.get("images") or not t.get("peak_flops"):
        return None
    seconds = kernel_seconds(t.get("device_ops", []))
    if seconds <= 0:
        return None
    W, H = conf["config"]["INPUT_SIZE"]
    return 100.0 * dcn_flops_per_image(conf, (H, W)) * t["images"] / t["peak_flops"] / seconds
