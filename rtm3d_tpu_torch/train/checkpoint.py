"""Checkpoints of the port, and weights carried into it.

- ``CheckPointer``: save and resume the train state, one ``torch.save``
  file per save with a ``last_checkpoint`` pointer (port of
  ``rtm3d_tpu/train/checkpoint.py:37-175``; reference
  utils/check_point.py:116-175).
- ``state_dict_from_jax``: the JAX package's variables (nested dicts of
  numpy arrays, ``{"params": ..., "batch_stats": ...}``) -> this package's
  state_dict, by exact name. The name and layout translation is the port's
  own copy of ``rtm3d_tpu/train/checkpoint.py::_to_dotted`` (:221-288) and
  ``::_convert_array_back`` (:375-390): conv HWIO -> OIHW, transposed conv
  (kh, kw, out, in) -> (in, out, kh, kw), BN scale/bias/mean/var ->
  weight/bias/running_mean/running_var.
- ``load_reference_checkpoint``: a reference ``.pt`` (port of
  ``load_torch_state_dict``, :305-315). The port's modules carry the
  reference names, so the result loads with ``strict=True`` as it is.

Flax msgpack checkpoints are not read yet, and neither orbax directories
nor multi-process saves are written (ROADMAP.md, queue A).
"""

from __future__ import annotations

import math
import os
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn


class CheckPointer:
    """``<name>.pt`` files under ``save_dir`` with a ``last_checkpoint``
    pointer file that each save tags.

    A file holds the model's state dict (parameters and BN buffers), the
    optimizer's state dict, the EMA shadow (or None), ``step``,
    ``updates``, ``epoch`` and ``min_loss``. ``max_to_keep`` bounds the
    rolling ``model_*`` files (the oldest go; ``model_best`` is never
    removed): the reference saves every epoch without bound
    (train.py:158-162)."""

    def __init__(self, save_dir: str, max_to_keep: int = 5):
        self.save_dir = save_dir
        self.max_to_keep = max_to_keep
        os.makedirs(save_dir, exist_ok=True)

    # -- pointer file (check_point.py:156-175) --
    def _tag_file(self) -> str:
        return os.path.join(self.save_dir, "last_checkpoint")

    def has_checkpoint(self) -> bool:
        return os.path.exists(self._tag_file())

    def get_checkpoint_file(self) -> str:
        try:
            with open(self._tag_file()) as f:
                return f.read().strip()
        except OSError:
            return ""

    def tag_last_checkpoint(self, path: str):
        with open(self._tag_file(), "w") as f:
            f.write(path)

    # -- save/load --
    def save(self, name: str, state, epoch: int = 0, min_loss: float = math.inf) -> str:
        payload = {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "ema": state.ema,
            "step": int(state.step),
            "updates": int(state.updates),
            "epoch": int(epoch),
            "min_loss": float(min_loss),
        }
        path = os.path.join(self.save_dir, f"{name}.pt")
        torch.save(payload, path)
        self.tag_last_checkpoint(path)
        self._enforce_retention(keep=os.path.basename(path))
        return path

    def _enforce_retention(self, keep: str):
        if not self.max_to_keep or self.max_to_keep <= 0:
            return
        rolling = sorted(
            f for f in os.listdir(self.save_dir)
            if f.startswith("model_") and not f.startswith("model_best") and f.endswith(".pt")
        )
        for f in rolling[: max(0, len(rolling) - self.max_to_keep)]:
            if f != keep:
                try:
                    os.remove(os.path.join(self.save_dir, f))
                except OSError:
                    pass

    def load(self, state_template, path: Optional[str] = None, use_latest: bool = True):
        """Returns ``(state, meta)``, meta = {'epoch', 'min_loss'}: the file
        (the pointer's when ``use_latest``) restored in place into
        ``state_template``, bit for bit, on the template's device. With no
        file, ``(state_template, {})`` (check_point.py:139-145)."""
        if use_latest and self.has_checkpoint():
            path = self.get_checkpoint_file()
        if not path or not os.path.exists(path):
            return state_template, {}
        # read to the host: load_state_dict copies each tensor onto its
        # template's device, and leaves Adamax's step counters on the host
        # where the optimizer keeps them
        payload = torch.load(path, map_location="cpu", weights_only=True)
        state_template.model.load_state_dict(payload["model"], strict=True)
        state_template.optimizer.load_state_dict(payload["optimizer"])
        if (payload["ema"] is None) != (state_template.ema is None):
            raise ValueError(f"{path}: the EMA shadow is {'absent' if payload['ema'] is None else 'present'}, "
                             "the train state's is not")
        if payload["ema"] is not None:
            with torch.no_grad():
                for k, v in state_template.ema.items():
                    v.copy_(payload["ema"][k])
        state_template.step = payload["step"]
        state_template.updates = payload["updates"]
        return state_template, {"epoch": payload["epoch"], "min_loss": payload["min_loss"]}


_HEAD_BRANCHES = ("main_kf", "offset_fr_main", "main_offset", "vertex_offset", "vertex_kf")


def _to_dotted(flax_path: Tuple[str, ...]) -> str:
    """Translate a flax param path to the reference/torch naming.

    Covers: ResNet blocks ('block0' -> '0', downsample pairs), DLA
    (base/project/norm naming), ConvLevel -> torch Sequential indices
    ('layerI/conv' -> 3I, 'layerI/bn' -> 3I+1, make_conv_level layout
    torch_utils.py:194-203), header branches ('main_kf' ->
    'main_kf_header', final 'head' -> '<branch>_head', header.py:15-37),
    UpSample kernels -> 'conv_tran.weight' (module.py:7-15), fusion_up
    chains 'fusion_upL_J' -> 'fusion_upL.J'.
    """
    parts = list(flax_path)
    out = []
    i = 0
    branch = next((p for p in parts if p in _HEAD_BRANCHES), None)
    while i < len(parts):
        p = parts[i]
        nxt = parts[i + 1] if i + 1 < len(parts) else ""
        m_layer = re.fullmatch(r"layer(\d+)", p)
        m_block = re.fullmatch(r"block(\d+)", p)
        m_fup = re.fullmatch(r"(fusion_up\d+)_(\d+)", p)
        if p == "kernel":
            if out and re.fullmatch(r"(kfpn_up\d+|fusion_up\d+(\.\d+)?)", out[-1]):
                out.append("conv_tran.weight")  # UpSample transposed conv
            else:
                out.append("weight")
        elif p == "scale":
            out.append("weight")
        elif p == "mean":
            out.append("running_mean")
        elif p == "var":
            out.append("running_var")
        elif m_layer and nxt in ("conv", "bn"):
            # ConvBNReLU #I inside a ConvLevel == torch Sequential index
            idx = int(m_layer.group(1))
            out.append(str(3 * idx) if nxt == "conv" else str(3 * idx + 1))
            i += 1  # consume the 'conv'/'bn' wrapper
        elif m_block:
            out.append(m_block.group(1))
        elif m_fup:
            out.append(f"{m_fup.group(1)}.{m_fup.group(2)}")
        elif p == "downsample_conv":
            out.append("downsample.0")
        elif p == "downsample_bn":
            out.append("downsample.1")
        elif p == "project_conv":
            out.append("project.0")
        elif p == "project_norm":
            out.append("project.1")
        elif p == "base_conv":
            out.append("base_layer.0")
        elif p == "base_norm":
            out.append("base_layer.1")
        elif p in _HEAD_BRANCHES and nxt in ("convs", "head"):
            out.append(f"{p}_header")
        elif p == "convs":
            pass  # HeadBranch ConvLevel wrapper: the Sequential is flat in torch
        elif p == "head" and branch:
            out.append(f"{branch}_head")
        elif p == "conv" and nxt in ("kernel", "bias"):
            pass  # Conv wrapper module: collapse (the torch conv IS the parent)
        elif p == "bn" and nxt in ("scale", "bias", "mean", "var"):
            pass  # BatchNorm wrapper: collapse
        else:
            out.append(p)
        i += 1
    return ".".join(out)


def _convert_array_back(flax_arr: np.ndarray, torch_shape) -> Optional[np.ndarray]:
    """flax layout -> torch layout: conv (kh,kw,I,O) -> (O,I,kh,kw),
    transposed conv (kh,kw,O,I) -> (I,O,kh,kw), linear (I,O) -> (O,I). The
    perm order mirrors the JAX package's import priority, so square-kernel
    ambiguity resolves identically."""
    a = np.asarray(flax_arr)
    ts = tuple(torch_shape)
    if a.shape == ts:
        return a
    if a.ndim == 4:
        for perm in ((3, 2, 0, 1), (2, 3, 0, 1)):
            if np.transpose(a, perm).shape == ts:
                return np.ascontiguousarray(np.transpose(a, perm))
    if a.ndim == 2 and a.T.shape == ts:
        return np.ascontiguousarray(a.T)
    return None


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = v
    return flat


def state_dict_from_jax(variables: Mapping[str, Any], model: nn.Module) -> Dict[str, torch.Tensor]:
    """Translate JAX variables into a state_dict for ``model`` (strict).

    Every key of ``model.state_dict()`` is filled and every JAX leaf is
    consumed, else ``KeyError``/``ValueError``. BatchNorm's
    ``num_batches_tracked`` has no JAX counterpart and keeps the model's
    value. Tensors come out on the CPU in the model's dtypes."""
    sources = {}
    for col in ("params", "batch_stats"):
        for path, val in _flatten(variables.get(col, {})).items():
            sources[_to_dotted(path)] = np.asarray(val)
    out, missing = {}, []
    for key, ref in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            out[key] = ref.detach().cpu().clone()
            continue
        if key not in sources:
            missing.append(key)
            continue
        arr = _convert_array_back(sources.pop(key), ref.shape)
        if arr is None:
            raise ValueError(f"{key}: no layout maps the JAX array onto {tuple(ref.shape)}")
        out[key] = torch.from_numpy(np.array(arr, copy=True)).to(ref.dtype)
    if missing or sources:
        raise KeyError(
            f"state_dict_from_jax: {len(missing)} model keys without a JAX leaf "
            f"{missing[:8]}, {len(sources)} JAX leaves unused {sorted(sources)[:8]}"
        )
    return out


def load_reference_checkpoint(pt_path: str) -> Dict[str, torch.Tensor]:
    """Read a reference ``.pt`` checkpoint into a plain state_dict (a
    DataParallel ``module.`` prefix is stripped). Loaded with
    ``weights_only=True``: tensors and containers only, no pickled code."""
    obj = torch.load(pt_path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and isinstance(obj.get("model"), dict):
        obj = obj["model"]
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {
        (k[7:] if k.startswith("module.") else k): v
        for k, v in obj.items()
        if isinstance(v, torch.Tensor)
    }
