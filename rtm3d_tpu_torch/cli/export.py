"""Model export: the detector's forward, and with ``--with-decode`` its
heatmap decode, as one ``torch.export`` program in a ``.pt2`` file.

Port of ``rtm3d_tpu/cli/export.py`` (a StableHLO artifact from
``jax.export`` there). The contract is the JAX artifact's:

- input: the preprocessed float32 frame batch (B, H, W, 3), NHWC, at the
  batch and ``INPUT_SIZE`` given at export; the NCHW permute and the cast
  to ``TPU.COMPUTE_DTYPE`` are inside the program;
- output: the 4 logit maps (NCHW, as the port's model gives them) or, with
  ``--with-decode``, the dict of ``decode/peaks.py::decode_detections``;
- the weights are baked in at ``TPU.COMPUTE_DTYPE``, parameters and BN
  statistics alike, as ``train/step.py::make_detect_step`` casts them, so
  that the program computes what the eager detect step computes;
- the LM solve stays outside, as in the JAX artifact: it is a ctypes
  kernel that ``torch.export`` cannot trace.
  ``train/step.py::make_detect_step_from_export`` runs normalise or the
  device warp, the program, decode when the program is logits-only, and
  the 3D solve with the LM kernel.

The program is traced in eval mode under ``torch.no_grad`` (a train-mode
BatchNorm traced in would update and normalise by batch statistics: the
export refuses a graph that holds one).

``--platforms`` lists the devices the artifact serves on (``cpu``,
``cuda``; the export's own device when not given). One ATen graph runs on
each device whose tensors it is given, unless an operation in it names a
device: a tensor made on the export's device, or the device assertions
``torch.export`` adds for each ``.to()``. The export drops those
assertions (its input's dtype and shape are checked by the program's own
input spec) and refuses a graph that still names a device when the
artifact is to serve anywhere but where it was made. ``load_exported``
refuses a device outside the list.

    python -m rtm3d_tpu_torch.cli.export --model-config CFG --output model.pt2 \\
        [--checkpoint CKPT] [--batch-size N] [--with-decode] [--platforms cpu,cuda] \\
        [--set KEY VALUE ...] [--device cpu]
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import time

import torch
from torch import nn

from rtm3d_tpu_torch.config import Config, load_config
from rtm3d_tpu_torch.decode.peaks import decode_detections
from rtm3d_tpu_torch.nn.model import create_model
from rtm3d_tpu_torch.train.checkpoint import load_detect_weights
from rtm3d_tpu_torch.train.step import compute_dtype, resolve_device

PLATFORMS = ("cpu", "cuda")
_META = "rtm3d_export.json"  # the artifact's own record, an extra file of the .pt2


def parse_args(argv=None):
    p = argparse.ArgumentParser("rtm3d_tpu_torch export")
    p.add_argument("--model-config", type=str, required=True)
    p.add_argument("--output", type=str, required=True)
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--with-decode", action="store_true",
                   help="include heatmap decode (peaks+vertices) in the export")
    p.add_argument("--platforms", type=str, default=None,
                   help="comma-separated devices the artifact serves on (cpu, cuda); default: --device's")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu: where the trace runs")
    p.add_argument("--set", nargs="*", default=[])
    return p.parse_args(argv)


class DetectProgram(nn.Module):
    """What the artifact computes: NHWC float32 frames -> the network at
    ``dtype`` -> the 4 logit maps, or the decoded detections."""

    def __init__(self, net: nn.Module, dtype: torch.dtype, decode: dict | None):
        super().__init__()
        self.net = net
        self.dtype = dtype
        self.decode = decode

    def forward(self, images):
        # NHWC -> an NCHW view with channels_last strides, as the eager step
        logits = self.net(images.permute(0, 3, 1, 2).to(self.dtype))
        if self.decode is None:
            return tuple(logits)
        return decode_detections(logits, **self.decode)


def graph_devices(ep) -> list:
    """``(node, device)`` for every operation of the exported graph that
    names a device."""
    return [(n.name, str(v)) for n in ep.graph.nodes
            for v in list(n.args) + list(n.kwargs.values()) if isinstance(v, torch.device)]


def export_detect(model: nn.Module, cfg: Config, batch: int, with_decode: bool, device,
                  platforms=None):
    """The exported program of ``model`` (a copy of it, in eval mode, on
    ``device``, cast to ``TPU.COMPUTE_DTYPE`` as the eager detect step
    holds it) at (batch, H, W, 3) float32, and the artifact's record.
    ``platforms``: the devices it is to serve on (default: the export's)."""
    device = torch.device(device)
    platforms = sorted(set(platforms or [device.type]))
    unknown = [p for p in platforms if p not in PLATFORMS]
    if unknown:
        raise ValueError(f"--platforms {unknown}: each must be one of {PLATFORMS}")
    dtype = compute_dtype(cfg)
    # contiguous weights in the file (torch.export.save stores a strided
    # tensor's storage only when the tensor covers it whole);
    # load_exported lays them out channels_last, as the eager step does
    net = copy.deepcopy(model).to(device=device, dtype=dtype).eval()
    decode = None
    if with_decode:
        decode = {"score_thresh": float(cfg.DETECTOR.SCORE_THRESH), "topk": int(cfg.DETECTOR.TOPK_CANDIDATES),
                  "down_sample": float(cfg.MODEL.DOWN_SAMPLE)}
    w, h = int(cfg.INPUT_SIZE[0]), int(cfg.INPUT_SIZE[1])
    example = torch.zeros((batch, h, w, 3), dtype=torch.float32, device=device)
    with torch.no_grad():
        ep = torch.export.export(DetectProgram(net, dtype, decode).eval(), (example,))
    graph = ep.graph
    for node in list(graph.nodes):
        if node.op == "call_function" and node.target == torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
    ep.graph_module.recompile()
    # the example batch would be saved with the program: 102 MB of zeros at
    # b16 1280x416
    ep.example_inputs = None
    train_bn = [n.name for n in graph.nodes if n.op == "call_function"
                and n.target == torch.ops.aten.batch_norm.default and n.args[5]]
    if train_bn:
        raise AssertionError(f"the exported graph holds train-mode BatchNorm: {train_bn[:4]}")
    named = graph_devices(ep)
    if named and platforms != [device.type]:
        raise ValueError(f"the graph names a device, so it serves only on {device.type}, not on {platforms}: "
                         f"{named[:4]}")
    meta = {"batch": batch, "input_hw": [h, w], "with_decode": with_decode, "compute_dtype": str(cfg.TPU.COMPUTE_DTYPE),
            "platforms": platforms, "decode": decode}
    return ep, meta


def save_exported(ep, meta: dict, path: str) -> int:
    """Write the artifact; returns its size in bytes."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(ep, path, extra_files={_META: json.dumps(meta)})
    return os.path.getsize(path)


class ExportedDetect:
    """A loaded artifact on one device: ``exported(images)`` runs it on
    (batch, H, W, 3) float32 frames; ``batch``, ``input_hw``,
    ``with_decode`` and ``platforms`` are its record."""

    def __init__(self, module: nn.Module, meta: dict, device: torch.device):
        self.module, self.meta, self.device = module, meta, device
        self.batch = int(meta["batch"])
        self.input_hw = tuple(meta["input_hw"])
        self.with_decode = bool(meta["with_decode"])
        self.platforms = list(meta["platforms"])

    def __call__(self, images):
        return self.module(images)


def load_exported(path: str, device=None) -> ExportedDetect:
    """The artifact at ``path`` on ``device`` (the GPU when None), the
    counterpart of ``rtm3d_tpu/cli/export.py:93-97``. Its weights move to
    ``device``, channels_last as the eager detect step holds them; the
    graph is used as it was saved."""
    device = resolve_device(device)
    extra = {_META: ""}
    ep = torch.export.load(path, extra_files=extra)
    meta = json.loads(extra[_META])
    if device.type not in meta["platforms"]:
        raise ValueError(f"{path} was exported for {meta['platforms']}, not for {device.type} "
                         "(export it again with --platforms)")
    return ExportedDetect(ep.module().to(device=device, memory_format=torch.channels_last), meta, device)


def main(argv=None) -> dict:
    """Export; returns the artifact's record with ``path``, ``bytes`` and
    ``seconds`` (weights load excluded)."""
    args = parse_args(argv)
    device = resolve_device(None if args.device == "cuda" else args.device)
    cfg = load_config(args.model_config, args.set)
    model = create_model(cfg)
    load_detect_weights(args.checkpoint or cfg.DETECTOR.CHECKPOINT, model)
    platforms = args.platforms.split(",") if args.platforms else None
    t0 = time.perf_counter()
    ep, meta = export_detect(model, cfg, args.batch_size, args.with_decode, device, platforms)
    nbytes = save_exported(ep, meta, args.output)
    seconds = time.perf_counter() - t0
    h, w = meta["input_hw"]
    print(f"exported {'detect' if args.with_decode else 'forward'} ({args.batch_size}x{h}x{w}x3, "
          f"{meta['compute_dtype']}, platforms {','.join(meta['platforms'])}) -> {args.output} "
          f"({nbytes / 1e6:.1f} MB, {seconds:.1f}s)")
    return dict(meta, path=args.output, bytes=nbytes, seconds=seconds)


if __name__ == "__main__":
    main()
