"""Post-training int8 quantization for the serving path.

Port of ``rtm3d_tpu/nn/quant.py``. Every ``layers.Conv`` of the network
(backbone, KFPN 1x1s, header branches) runs as an int8 x int8 -> int32
convolution (``ops/int8_conv.py``: ``quantize`` then ``conv_s8``, hand-written
CUDA kernels on the card); BN, ReLU, the transposed convs (``UpSample``),
the KFPN softmax fusion, decode and the 3D solver stay in float. Scheme:

- weights: symmetric per-output-channel scales (absmax / 127), quantized
  from the float weights the serving step holds (cast to
  ``TPU.COMPUTE_DTYPE`` first, as the JAX step casts its variables before
  the apply), so checkpoints are untouched;
- activations: symmetric clips from a calibration sweep over
  representative batches (``calibrate_act_scales``; saved and loaded as
  JSON in the JAX package's layout): absmax, the 99.9 or 99.99 percentile
  of |x|, or the MSE-optimal clip of a 16-point grid; convs matched by
  ``per_channel`` patterns calibrate one clip per input channel, folded
  into the weights (exact for the conv sum).

Scale keys are the JAX package's module paths (``"/".join(module.path)``,
e.g. ``backbone/level2/tree1/conv1``, ``detect_header/main_kf/head``):
``jax_path`` maps a port module name to it, as the inverse of
``train/checkpoint.py::_to_dotted`` on the conv's kernel path. So a scales
JSON written by either package serves the other, and ``TPU.INT8_SKIP``
(default ``("/head",)``) matches the same convs.

PyTorch idiom in place of flax interception: calibration registers forward
pre-hooks on the convs; ``quantize_model`` returns a copy of the network
whose calibrated convs are ``QuantConv`` modules. A conv with no scale, or
a scale of 0, stays float. DLA-34's level-2 trees compute a residual
projection that nothing reads (the JAX package computes and drops it; the
port skips it in eval mode): calibration runs those projections too, so
the key set equals the JAX package's; in serving they run in neither.

Percentiles follow ``jnp.quantile``'s linear rule, in float32 as JAX
computes it, from the top order statistics (``torch.topk``):
``torch.quantile`` refuses inputs over 2^24 elements, and a DLA-34 stem
input at b32 1280x416 has 5.1e7.
"""

from __future__ import annotations

import copy
import json
import re
from typing import Dict, Iterable, List

import numpy as np
import torch
from torch import nn

from rtm3d_tpu_torch.nn.dla import Tree
from rtm3d_tpu_torch.nn.layers import Conv
from rtm3d_tpu_torch.ops import int8_conv
from rtm3d_tpu_torch.train.checkpoint import _HEAD_BRANCHES, _to_dotted

_SEQUENTIAL_CONV = {"base_layer": "base_conv", "project": "project_conv", "downsample": "downsample_conv"}


def jax_path(name: str) -> str:
    """The JAX module path of the port conv ``name`` (a ``named_modules``
    key): the inverse of ``_to_dotted`` on ``<path>/conv/kernel``."""
    parts = name.split(".")
    out: List[str] = []
    i = 0
    while i < len(parts):
        p = parts[i]
        nxt = parts[i + 1] if i + 1 < len(parts) else None
        branch = p[: -len("_header")] if p.endswith("_header") else None
        if p in _SEQUENTIAL_CONV and nxt == "0":
            out.append(_SEQUENTIAL_CONV[p])
            i += 1
        elif branch in _HEAD_BRANCHES:
            out.append(branch)
            if nxt is not None and nxt.isdigit():  # a ConvLevel conv of the branch
                out += ["convs", f"layer{int(nxt) // 3}", "conv"]
                i += 1
            elif nxt == f"{branch}_head":
                out.append("head")
                i += 1
        elif p.isdigit():
            prev = parts[i - 1] if i else ""
            # ResNet stages hold blocks; DLA levels and header branches are
            # ConvLevels (conv I at Sequential index 3I)
            out += [f"block{p}"] if re.fullmatch(r"layer\d+", prev) else [f"layer{int(p) // 3}", "conv"]
        else:
            out.append(p)
        i += 1
    path = "/".join(out)
    if _to_dotted(tuple(out) + ("conv", "kernel")) != f"{name}.weight":
        raise ValueError(f"no JAX module path maps onto the port conv {name!r} (tried {path!r})")
    return path


def conv_paths(model: nn.Module) -> Dict[str, str]:
    """{port module name: JAX path} of every ``layers.Conv`` of ``model``."""
    return {name: jax_path(name) for name, m in model.named_modules() if isinstance(m, Conv)}


def _match_fns(patterns: Iterable[str]):
    """Trailing "/" = path prefix (a whole submodule), else path suffix."""
    prefixes = tuple(p for p in patterns if p.endswith("/"))
    suffixes = tuple(p for p in patterns if not p.endswith("/"))

    def hit(k: str) -> bool:
        return (bool(suffixes) and k.endswith(suffixes)) or (bool(prefixes) and k.startswith(prefixes))

    return hit


def skip_scales(scales: Dict[str, object], skip: Iterable[str]) -> Dict[str, object]:
    """Zero the scale of the convs ``skip`` matches (``_match_fns`` rules):
    those stay float. The serving default, ``TPU.INT8_SKIP = ("/head",)``,
    keeps the header's output convs in float (their int8 error reaches the
    3D solver's residual acceptance)."""
    hit = _match_fns(skip)
    return {k: (0.0 if hit(k) else v) for k, v in scales.items()}


def quantile_f32(x: torch.Tensor, q: float, dim: int | None = None) -> torch.Tensor:
    """``jnp.quantile(x, q, axis=dim)`` with the linear rule as JAX computes
    it in float32 (q and the position q * (n - 1) rounded to float32), from
    the top ``n - floor(pos)`` values, on any size."""
    flat = x.reshape(-1) if dim is None else x
    d = 0 if dim is None else dim
    n = flat.shape[d]
    pos = np.float32(q) * (np.float32(n) - np.float32(1))
    low = np.float32(np.floor(pos))
    high_w = np.float32(pos - low)
    low_w = np.float32(np.float32(1) - high_w)
    lo = int(np.clip(low, 0, n - 1))
    hi = int(np.clip(np.ceil(pos), 0, n - 1))
    top = torch.topk(flat, n - lo, dim=d, largest=True, sorted=True).values  # descending
    low_v = top.select(d, n - 1 - lo)
    high_v = top.select(d, n - 1 - hi)
    dev = flat.device
    return (low_v * torch.tensor(low_w, device=dev)) + (high_v * torch.tensor(high_w, device=dev))


def _dead_projection_hooks(model: nn.Module, hooks: list) -> None:
    """Run the residual projection of each DLA tree above level 1 during
    calibration: the JAX package calls it in every forward (and drops the
    result), so its conv has a scale there."""
    def run(tree, args):
        x = args[0]
        tree.project(tree.downsample(x) if tree.downsample is not None else x)

    for m in model.modules():
        if isinstance(m, Tree) and m.level > 1 and m.project is not None:
            hooks.append(m.register_forward_pre_hook(run))


def _sweep(model: nn.Module, batches, stat) -> None:
    """One eval-mode, no-grad forward of each batch (NHWC) with
    ``stat(key, input)`` called at every conv's input."""
    keys = conv_paths(model)
    hooks: list = []

    def hook(key):
        def pre(mod, args):
            stat(key, args[0])  # and None: the conv's input stays as it is

        return pre

    for name, m in model.named_modules():
        if name in keys:
            hooks.append(m.register_forward_pre_hook(hook(keys[name])))
    _dead_projection_hooks(model, hooks)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            for b in batches:
                model(b.permute(0, 3, 1, 2))
    finally:
        model.train(was_training)
        for h in hooks:
            h.remove()


def conv_shapes(model: nn.Module, h: int, w: int, skip: Iterable[str] = ()) -> List[dict]:
    """Every conv of ``model`` (best built on the meta device) at an (h, w)
    input, from calibration's sweep, so DLA-34's dead projections are in:
    its JAX path ``key``, ``cin``, ``cout``, ``k``, ``stride``, ``pad``,
    ``dil``, its input's ``h`` and ``w``, and ``served``: whether a serving
    forward runs it int8 (the dead projections run in no forward; the convs
    ``skip`` matches, ``_match_fns`` rules, stay float)."""
    device = next(model.parameters()).device
    mods = {p: model.get_submodule(n) for n, p in conv_paths(model).items()}
    shapes, ran = {}, set()
    _sweep(model, [torch.empty(1, h, w, 3, device=device)], lambda k, x: shapes.setdefault(k, tuple(x.shape)))
    hooks = [m.register_forward_pre_hook(lambda m, a, k=k: ran.add(k)) for k, m in mods.items()]
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            model(torch.empty(1, 3, h, w, device=device))
    finally:
        model.train(was_training)
        for hk in hooks:
            hk.remove()
    hit = _match_fns(tuple(skip))
    return [{"key": k, "cin": shapes[k][1], "cout": m.out_channels, "k": m.kernel_size[0], "stride": m.stride[0],
             "pad": m.padding[0], "dil": m.dilation[0], "h": shapes[k][2], "w": shapes[k][3],
             "served": k in ran and not hit(k)} for k, m in mods.items()]


def calibrate_act_scales(model: nn.Module, batches, method: str = "absmax", per_channel: Iterable[str] = (),
                         mse_grid: int = 16) -> Dict[str, object]:
    """Activation clips of every conv over ``batches`` ((B, H, W, 3) float
    tensors, normalised as the detect step feeds the network, on the
    model's device), as ``rtm3d_tpu/nn/quant.py::calibrate_act_scales``:

    - ``absmax``: max |input| per conv (max across batches);
    - ``p99.9`` / ``p99.99``: that percentile of |input| (max across batches);
    - ``mse``: per conv, the clip c of a ``mse_grid``-point grid up to the
      absmax minimising E[(x - dequant(quant_c(x)))^2] summed over batches
      (two passes: absmax, then the errors).

    ``per_channel`` patterns (``_match_fns`` rules) select convs that
    calibrate one clip per input channel (a list); under ``mse`` those take
    per-channel absmax. Returns {JAX path: float or list of floats}. The
    model runs as given (its dtype and device); the CLI calibrates the fp32
    network with TF32 off."""
    batches = list(batches)
    is_pc = _match_fns(per_channel)
    q = {"p99.9": 99.9, "p99.99": 99.99}.get(method)
    if method not in ("absmax", "mse") and q is None:
        raise ValueError(f"unknown calibration method {method!r}")
    stats: Dict[str, np.ndarray] = {}

    def batch_stats(k, x):
        x = x.detach().float().abs()
        if is_pc(k):
            flat = x.permute(0, 2, 3, 1).reshape(-1, x.shape[1])
            v = quantile_f32(flat, q / 100.0, dim=0) if (q is not None and method != "mse") else flat.amax(0)
        else:
            v = quantile_f32(x, q / 100.0) if q is not None else x.max()
        v = v.double().cpu().numpy()
        stats[k] = np.maximum(stats[k], v) if k in stats else np.maximum(0.0, v)

    # the JAX sweep keeps each conv's max over its calls within a batch,
    # then the max across batches: the same thing
    _sweep(model, batches, batch_stats)

    if method == "mse":
        amax = {k: float(v) for k, v in stats.items() if np.ndim(v) == 0}
        mse: Dict[str, np.ndarray] = {}

        def batch_mse(k, x):
            if k not in amax or amax[k] <= 0.0:
                return
            x = x.detach().float()
            errs = []
            for i in range(mse_grid):
                s = torch.tensor(amax[k] * (i + 1) / mse_grid / 127.0, dtype=torch.float32, device=x.device)
                xq = torch.round(x / s).clamp_(-127, 127) * s
                errs.append(((x - xq) ** 2).mean())
            e = torch.stack(errs).double().cpu().numpy()
            mse[k] = mse[k] + e if k in mse else e

        _sweep(model, batches, batch_mse)
        for k, e in mse.items():
            stats[k] = amax[k] * (int(np.argmin(e)) + 1) / mse_grid

    return {k: (float(v) if np.ndim(v) == 0 else [float(x) for x in v]) for k, v in stats.items()}


def save_act_scales(path: str, scales: Dict[str, object]) -> None:
    with open(path, "w") as f:
        json.dump(scales, f, indent=1, sort_keys=True)


def load_act_scales(path: str) -> Dict[str, object]:
    with open(path) as f:
        return {k: ([float(x) for x in v] if isinstance(v, list) else float(v)) for k, v in json.load(f).items()}


class QuantConv(nn.Module):
    """int8 twin of a ``layers.Conv`` (``rtm3d_tpu/nn/quant.py::_quantized_conv``),
    holding that conv's float weight and bias and the activation clip:
    a float (per tensor) or one per input channel, folded into the weights;
    a channel whose clip is 0 (dead in calibration) takes the largest clip.

    The int8 weights, per-output-channel scales and float32 bias are packed
    from the float weights at the first forward after any ``.to()`` (the
    serving step casts before it runs), on their device; the activation
    scale is computed as JAX computes it: per tensor ``max(clip / 127,
    1e-12)`` in double, then float32; per channel in float32."""

    def __init__(self, conv: Conv, clip):
        super().__init__()
        self.weight = conv.weight
        self.bias = conv.bias
        self.kernel_size = tuple(conv.kernel_size)
        self.stride = int(conv.stride[0])
        self.padding = int(conv.padding[0])
        self.dilation = int(conv.dilation[0])
        self.in_channels = conv.in_channels
        if np.ndim(clip) > 0 and len(clip) != conv.in_channels:
            raise ValueError(f"a per-channel clip of {len(clip)} values for a conv of {conv.in_channels} inputs")
        self.clip = float(clip) if np.ndim(clip) == 0 else [float(c) for c in clip]
        self._packed = None

    def _apply(self, *args, **kwargs):
        self._packed = None  # a cast or a move: pack again from the new weights
        return super()._apply(*args, **kwargs)

    @torch.no_grad()
    def pack(self):
        """(s_x (Cin,) float32, packed int8 weights, out_scale, bias) from
        the current weights, on their device."""
        w = self.weight.detach().float()
        dev = w.device
        cin = self.in_channels
        if np.ndim(self.clip) == 0:
            s_x = np.float32(max(self.clip / 127.0, 1e-12))
            s_w = (w.abs().amax(dim=(1, 2, 3)) / torch.tensor(127.0, device=dev)).clamp_min_(1e-12)
            wq = torch.round(w / s_w[:, None, None, None]).clamp_(-127, 127)
            out_scale = s_w * torch.tensor(s_x, device=dev)
            scale = torch.full((cin,), float(s_x), dtype=torch.float32, device=dev)
        else:
            clip = np.asarray(self.clip, np.float32)
            if (clip <= 0.0).any():
                clip = np.where(clip <= 0.0, clip.max(), clip)
            s_x = np.maximum(clip / np.float32(127.0), np.float32(1e-12)).astype(np.float32)
            scale = torch.from_numpy(s_x).to(dev)
            w_eff = w * scale[None, :, None, None]
            s_w = (w_eff.abs().amax(dim=(1, 2, 3)) / torch.tensor(127.0, device=dev)).clamp_min_(1e-12)
            wq = torch.round(w_eff / s_w[:, None, None, None]).clamp_(-127, 127)
            out_scale = s_w  # s_x is folded into the weights
        bias = self.bias.detach().float().contiguous() if self.bias is not None else None
        return scale.contiguous(), int8_conv.pack_weight(wq.to(torch.int8)), out_scale.contiguous(), bias

    def forward(self, x):
        if self._packed is None:
            self._packed = self.pack()
        scale, w, out_scale, bias = self._packed
        xq = int8_conv.quantize(x, scale, int8_conv.padded_channels(self.in_channels))
        y = int8_conv.conv_s8(xq, w, self.kernel_size, self.stride, self.padding, self.dilation, out_scale, bias,
                              x.dtype)
        return y.permute(0, 3, 1, 2)  # NHWC memory as an NCHW view: channels_last


def quantize_model(model: nn.Module, scales: Dict[str, object]) -> nn.Module:
    """A copy of ``model`` whose convs with a positive scale (a per-channel
    list with a positive entry) are ``QuantConv``; the rest stay float."""
    model = copy.deepcopy(model)
    for name, path in conv_paths(model).items():
        s = scales.get(path, 0.0)
        if (np.ndim(s) > 0 and max(s) > 0.0) or (np.ndim(s) == 0 and s > 0.0):
            parent_name, _, attr = name.rpartition(".")
            parent = model.get_submodule(parent_name) if parent_name else model
            setattr(parent, attr, QuantConv(getattr(parent, attr), s))
    return model
