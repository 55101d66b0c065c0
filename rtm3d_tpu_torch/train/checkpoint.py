"""Weights carried into the port.

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

Flax msgpack checkpoints are not read yet (ROADMAP.md, queue A).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

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
