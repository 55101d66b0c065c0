"""Checkpoints of the port, and weights carried into it.

- ``CheckPointer``: save and resume the train state, one ``torch.save``
  file per save with a ``last_checkpoint`` pointer (port of
  ``rtm3d_tpu/train/checkpoint.py:37-175``; reference
  utils/check_point.py:116-175), or under ``TRAINING.USE_ORBAX`` one
  ``torch.distributed.checkpoint`` directory per save, written by every
  rank (the JAX package's collective orbax directories, :56-61, 98-123;
  the format is torch's, not orbax's).
- ``state_dict_from_jax``: the JAX package's variables (nested dicts of
  numpy arrays, ``{"params": ..., "batch_stats": ...}``) -> this package's
  state_dict, by exact name. The name and layout translation is the port's
  own copy of ``rtm3d_tpu/train/checkpoint.py::_to_dotted`` (:221-288) and
  ``::_convert_array_back`` (:375-390): conv HWIO -> OIHW, transposed conv
  (kh, kw, out, in) -> (in, out, kh, kw), BN scale/bias/mean/var ->
  weight/bias/running_mean/running_var.
- ``load_torch_weights``: a torch weights file as a detector serves it: a
  ``CheckPointer`` file with the EMA shadow laid over the parameters when
  the run tracked one (``TrainState.eval_variables``; reference
  check_point.py:122), any other as a reference ``.pt`` (port of
  ``load_torch_state_dict``, :305-315; the port's modules carry the
  reference names).
- ``read_flax_msgpack`` / ``load_flax_checkpoint``: the JAX package's
  msgpack checkpoints, read with ``msgpack`` alone (no flax), the EMA
  preferred, into ``state_dict_from_jax``.
- ``import_reference_weights``: longest-suffix matching of a partial
  state_dict, an ImageNet backbone for instance, into the model (port of
  ``import_torch_weights``, :318-372; reference check_point.py:14-92).
- ``load_detect_weights``: what the detect CLI and ``Detector.from_config``
  load, by file kind (``rtm3d_tpu/cli/detect.py:92-130``).
- ``strip_checkpoint``: a deploy file of a port checkpoint, the EMA
  preferred, float32 cast to bfloat16 (``strip_checkpoint``, :178-210).

The JAX package's orbax directories are not read (ROADMAP.md).
"""

from __future__ import annotations

import math
import os
import re
import shutil
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from rtm3d_tpu_torch.parallel.dist import initialized, is_master, sync_processes


class CheckPointer:
    """``<name>.pt`` files under ``save_dir`` with a ``last_checkpoint``
    pointer file that each save tags; with ``use_orbax``
    (``TRAINING.USE_ORBAX``), ``<name>/`` directories of
    ``torch.distributed.checkpoint``.

    A save holds the model's state dict (parameters and BN buffers), the
    optimizer's state dict, the EMA shadow (or None), ``step``,
    ``updates``, ``epoch`` and ``min_loss``. ``max_to_keep`` bounds the
    rolling ``model_*`` saves (the oldest go; ``model_best`` is never
    removed): the reference saves every epoch without bound
    (train.py:158-162).

    Under a process group every rank calls ``save``. The train state is
    the same on every rank, so a ``.pt`` file is written by the master
    alone (train_multi_gpu.py:226-230; the other ranks return its path at
    once); a directory save is collective: each rank writes its share of
    the tensors, and the master tags the pointer. Either kind resumes in
    any world size."""

    def __init__(self, save_dir: str, max_to_keep: int = 5, use_orbax: bool = False):
        self.save_dir = save_dir
        self.max_to_keep = max_to_keep
        self.use_orbax = use_orbax
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
        if self.use_orbax:
            return self._save_dir(name, state, epoch, min_loss)
        path = os.path.join(self.save_dir, f"{name}.pt")
        if not is_master():
            return path
        payload = {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "ema": state.ema,
            "step": int(state.step),
            "updates": int(state.updates),
            "epoch": int(epoch),
            "min_loss": float(min_loss),
        }
        torch.save(payload, path)
        self.tag_last_checkpoint(path)
        self._enforce_retention(keep=os.path.basename(path))
        return path

    def _save_dir(self, name: str, state, epoch: int, min_loss: float) -> str:
        """A ``torch.distributed.checkpoint`` directory: the tensors under
        flat names (``model/``, ``ema/``, ``optimizer/<index>/``) and the
        rest as one item, ``meta``: a tuple, which the checkpoint stores
        whole (it would flatten a dict), so the optimizer's hyperparameters
        come back as they were (``betas`` a tuple). A save of an existing
        name replaces it."""
        import torch.distributed.checkpoint as dcp

        path = os.path.abspath(os.path.join(self.save_dir, name))
        if is_master() and os.path.isdir(path):
            shutil.rmtree(path)
        sync_processes(f"checkpoint_save:{name}")
        opt = state.optimizer.state_dict()
        payload = {f"model/{k}": v for k, v in state.model.state_dict().items()}
        payload.update({f"ema/{k}": v for k, v in (state.ema or {}).items()})
        payload.update({f"optimizer/{i}/{k}": v for i, st in opt["state"].items() for k, v in st.items()})
        payload["meta"] = ({
            "step": int(state.step), "updates": int(state.updates), "epoch": int(epoch),
            "min_loss": float(min_loss), "ema": state.ema is not None, "param_groups": opt["param_groups"],
        },)
        dcp.save(payload, checkpoint_id=path, no_dist=not initialized())
        if is_master():
            self.tag_last_checkpoint(path)
            self._enforce_retention(keep=os.path.basename(path))
        return path

    def _enforce_retention(self, keep: str):
        if not self.max_to_keep or self.max_to_keep <= 0:
            return
        rolling = sorted(
            f for f in os.listdir(self.save_dir)
            if f.startswith("model_") and not f.startswith("model_best")
            and (f.endswith(".pt") or os.path.isdir(os.path.join(self.save_dir, f)))
        )
        for f in rolling[: max(0, len(rolling) - self.max_to_keep)]:
            if f != keep:
                target = os.path.join(self.save_dir, f)
                try:
                    if os.path.isdir(target):
                        shutil.rmtree(target)
                    else:
                        os.remove(target)
                except OSError:
                    pass

    def load(self, state_template, path: Optional[str] = None, use_latest: bool = True):
        """Returns ``(state, meta)``, meta = {'epoch', 'min_loss'}: the save
        (the pointer's when ``use_latest``), a ``.pt`` file or a directory
        of either world size, restored in place into ``state_template``,
        bit for bit, on the template's device. With no save,
        ``(state_template, {})`` (check_point.py:139-145). A directory is
        loaded collectively: under a process group every rank calls."""
        if use_latest and self.has_checkpoint():
            path = self.get_checkpoint_file()
        if not path or not os.path.exists(path):
            return state_template, {}
        # read to the host: load_state_dict copies each tensor onto its
        # template's device, and leaves Adamax's step counters on the host
        # where the optimizer keeps them
        if os.path.isdir(path):
            payload = read_checkpoint_dir(path)
        else:
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


def is_checkpoint_dir(path: str) -> bool:
    """True for a directory that ``CheckPointer`` wrote (``use_orbax``)."""
    return os.path.isfile(os.path.join(path, ".metadata"))


def read_checkpoint_dir(path: str) -> Dict[str, Any]:
    """A ``CheckPointer`` directory save as the payload of a ``.pt`` save
    (``model``, ``optimizer``, ``ema``, ``step``, ``updates``, ``epoch``,
    ``min_loss``), its tensors on the host, in any world size: the
    template of the load is the directory's own list of tensors. Under a
    process group every rank must make the call (the load is
    collective)."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    listed = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    payload = {k: (torch.empty(tuple(m.size), dtype=m.properties.dtype)
                   if isinstance(m, TensorStorageMetadata) else "") for k, m in listed.items()}
    dcp.load(payload, checkpoint_id=path, no_dist=not initialized())
    (meta,) = payload.pop("meta")
    parts: Dict[str, Dict[str, torch.Tensor]] = {"model": {}, "ema": {}, "optimizer": {}}
    for k, v in payload.items():
        kind, name = k.split("/", 1)
        parts[kind][name] = v
    optim_state: Dict[int, Dict[str, torch.Tensor]] = {}
    for k, v in parts["optimizer"].items():
        i, key = k.split("/", 1)
        optim_state.setdefault(int(i), {})[key] = v
    return {
        "model": parts["model"], "ema": parts["ema"] if meta["ema"] else None,
        "optimizer": {"state": optim_state, "param_groups": meta["param_groups"]},
        **{k: meta[k] for k in ("step", "updates", "epoch", "min_loss")},
    }


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
            # a bfloat16 leaf comes as a tensor (numpy has no bfloat16);
            # its float32 value is exact
            sources[_to_dotted(path)] = val.float().numpy() if torch.is_tensor(val) else np.asarray(val)
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


def _is_port_checkpoint(obj) -> bool:
    """True for the payload of a ``CheckPointer.save`` file."""
    return isinstance(obj, dict) and {"model", "optimizer", "ema", "updates"} <= set(obj)


def _reference_weights(obj) -> Dict[str, torch.Tensor]:
    if isinstance(obj, dict) and isinstance(obj.get("model"), dict):
        obj = obj["model"]
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {
        (k[7:] if k.startswith("module.") else k): v
        for k, v in obj.items()
        if isinstance(v, torch.Tensor)
    }


def _torch_load(path: str):
    # weights_only: tensors and containers only, no pickled code
    return torch.load(path, map_location="cpu", weights_only=True)


def load_torch_weights(path: str) -> Tuple[Dict[str, torch.Tensor], bool]:
    """``(state_dict, used_ema)`` of a torch weights file or a port
    ``CheckPointer`` directory. A port save gives its model's parameters and buffers with the
    EMA shadow, when the run tracked one, in place of the parameters, as
    ``TrainState.eval_variables`` evaluates them (the reference CheckPointer
    prefers the EMA model, check_point.py:122); any other file is read as a
    reference checkpoint."""
    obj = read_checkpoint_dir(path) if is_checkpoint_dir(path) else _torch_load(path)
    if not _is_port_checkpoint(obj):
        return _reference_weights(obj), False
    sd, ema = dict(obj["model"]), obj["ema"]
    sd.update(ema or {})
    return sd, bool(ema)


# -- flax msgpack, read without flax (flax/serialization.py's format) --
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


def _flax_array(data: bytes):
    """An ext payload ``(shape, dtype name, C-order bytes)``: a numpy array,
    or for ``bfloat16``, which numpy cannot name, a ``torch.bfloat16``
    tensor over the same bits."""
    import msgpack

    shape, dtype, buf = msgpack.unpackb(data, raw=True)
    if dtype == b"bfloat16":
        bits = np.frombuffer(buf, np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, np.dtype(dtype.decode())).reshape(shape)


def _flax_ext(code: int, data: bytes):
    import msgpack

    if code == _EXT_NDARRAY:
        return _flax_array(data)
    if code == _EXT_NPSCALAR:
        a = _flax_array(data)
        return a if torch.is_tensor(a) else a[()]
    if code == _EXT_COMPLEX:
        re_, im = msgpack.unpackb(data)
        return complex(re_, im)
    raise ValueError(f"msgpack ext type {code} is not one of flax's (1 ndarray, 2 complex, 3 numpy scalar)")


def _unchunk(tree):
    """flax writes leaves over 2**30 bytes as ``{"__msgpack_chunked_array__":
    True, "shape": {"0": d0, ...}, "chunks": {"0": flat part, ...}}``; this
    rebuilds each such leaf."""
    if not isinstance(tree, dict):
        return tree
    if tree.get("__msgpack_chunked_array__"):
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        flat = torch.cat(chunks) if torch.is_tensor(chunks[0]) else np.concatenate(chunks)
        return flat.reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def read_flax_msgpack(path: str) -> Any:
    """The tree of a flax msgpack file (``serialization.to_bytes`` or
    ``msgpack_serialize``): dicts of numpy arrays and scalars, bfloat16
    leaves as ``torch.bfloat16`` tensors, chunked leaves rebuilt."""
    import msgpack

    with open(path, "rb") as f:
        return _unchunk(msgpack.unpackb(f.read(), ext_hook=_flax_ext, raw=False))


def load_flax_checkpoint(path: str, model: nn.Module) -> Tuple[Dict[str, torch.Tensor], bool]:
    """``(state_dict, used_ema)`` of a JAX package checkpoint for ``model``:
    a full ``CheckPointer`` file (``{"state": {params, batch_stats,
    opt_state, step, ema_params}, epoch, min_loss}``) or a stripped deploy
    file (``{params, batch_stats}``, bfloat16 by default). ``ema_params``
    is served when it is a non-empty dict, as the JAX detect CLI does."""
    payload = read_flax_msgpack(path)
    state = payload.get("state", payload)
    ema = state.get("ema_params")
    use_ema = isinstance(ema, dict) and len(ema) > 0
    variables = {"params": ema if use_ema else state["params"], "batch_stats": state.get("batch_stats", {})}
    return state_dict_from_jax(variables, model), use_ema


def import_reference_weights(model: nn.Module, state_dict: Mapping[str, torch.Tensor],
                             verbose: bool = False) -> Dict[str, list]:
    """Load ``state_dict`` into ``model`` in place by longest-suffix
    matching of dotted names; returns ``{"loaded": [(model key, source
    key)], "missed": [...]}``.

    Each of the model's parameters and BN statistics takes the source key
    that scores highest: the same name 3x its length, a source name that
    ends the model's (a backbone-only file) 2x, a model name that ends the
    source's (a whole-model file into a sub-module) 1x; a ``module.``
    prefix is stripped. Both sides are torch layouts, so only the shapes
    are checked. ``num_batches_tracked`` has no JAX counterpart and is
    left as it is, so that the report counts what the JAX import counts."""
    current = model.state_dict()
    new, loaded, missed = dict(current), [], []
    for key, ref in current.items():
        if key.endswith("num_batches_tracked"):
            continue
        best_key, best = None, 0
        for tk in state_dict:
            tkn = tk[7:] if tk.startswith("module.") else tk
            if key == tkn:
                score = 3 * len(tkn)
            elif key.endswith("." + tkn):
                score = 2 * len(tkn)
            elif tkn.endswith("." + key):
                score = len(key)
            else:
                continue
            if score > best:
                best_key, best = tk, score
        if best_key is None:
            missed.append(key)
            continue
        src = state_dict[best_key]
        if tuple(src.shape) != tuple(ref.shape):
            missed.append(f"{key} (shape {tuple(src.shape)} vs {tuple(ref.shape)})")
            continue
        new[key] = src.detach().to(ref.dtype)
        loaded.append((key, best_key))
        if verbose:
            print(f"loaded {key:60s} <- {best_key}")
    model.load_state_dict(new, strict=True)
    return {"loaded": loaded, "missed": missed}


def strip_checkpoint(src: str, dst: str, dtype: str = "bfloat16") -> str:
    """Write a deploy file of ``src`` to ``dst`` and return ``dst``: one
    state dict of the model's parameters (the EMA shadow in their place
    when the run tracked one, as the JAX ``strip_checkpoint`` prefers it,
    :187-193, and the reference CheckPointer, check_point.py:122) and its
    BN statistics; the optimizer state, step and epoch are dropped.
    ``src`` is a port ``CheckPointer`` file or directory (any other torch
    file is read as a reference checkpoint, ``load_torch_weights``).
    Float32 tensors are cast to ``dtype`` (``""`` keeps float32), as the
    reference casts its pretrained file to half (utils/utils.py:89-110);
    ``num_batches_tracked`` stays int64. ``load_detect_weights`` serves the
    file as it serves a reference ``.pt``: each tensor by name, cast to the
    model's dtype."""
    sd, _ = load_torch_weights(src)
    if dtype:
        target = getattr(torch, dtype, None)
        if not isinstance(target, torch.dtype) or not target.is_floating_point:
            raise ValueError(f"strip_checkpoint: {dtype!r} is not a torch floating dtype")
        sd = {k: v.to(target) if v.dtype == torch.float32 else v for k, v in sd.items()}
    torch.save({k: v.detach().cpu().contiguous() for k, v in sd.items()}, dst)
    return dst


def load_detect_weights(path: Optional[str], model: nn.Module) -> str:
    """Load the weights a detector serves into ``model``, in place, as the
    JAX detect CLI's ``load_variables`` does (``rtm3d_tpu/cli/detect.py:
    92-130``), and return the line it prints:

    - ``.pt``/``.pth``/``.pkl``: ``import_reference_weights`` (suffix
      match), from a reference checkpoint, or from a port ``CheckPointer``
      file with its EMA shadow;
    - a ``CheckPointer`` directory (``TRAINING.USE_ORBAX``): as a port
      ``.pt`` file (collective: under a process group every rank calls);
    - any other directory: the JAX package's orbax checkpoint, not read;
    - any other file: a flax msgpack checkpoint, EMA preferred;
    - a ``.msgpack`` path that does not exist, with a port ``<stem>.pt``
      beside it: that file, as above. The configs name
      ``weights/<BACKBONE>/model_best.msgpack``, the file the JAX trainer
      writes, and the port's trainer writes ``model_best.pt`` there;
    - a path that does not exist: the model keeps its random weights, with
      a warning, as in the JAX package."""
    stand_in = ""
    if path and path.endswith(".msgpack") and not os.path.exists(path):
        pt = path[: -len(".msgpack")] + ".pt"
        if os.path.exists(pt):
            stand_in = f"{path} not found; serving the port's checkpoint {pt} beside it: "
            path = pt
    if path and os.path.isdir(path) and not is_checkpoint_dir(path):
        raise NotImplementedError(f"{path}: the JAX package's orbax directory checkpoints are not read by the "
                                  "port (ROADMAP.md, queue A: Data-parallel)")
    if not path or not os.path.exists(path):
        line = f"WARNING: checkpoint {path} not found; using random init" if path else "no checkpoint; random init"
    elif path.endswith((".pt", ".pth", ".pkl")) or is_checkpoint_dir(path):
        sd, ema = load_torch_weights(path)
        report = import_reference_weights(model, sd)
        line = (f"imported {len(report['loaded'])} tensors; {len(report['missed'])} missed"
                + (" (EMA weights)" if ema else ""))
    else:
        sd, ema = load_flax_checkpoint(path, model)
        model.load_state_dict(sd, strict=True)
        line = f"loaded checkpoint {path}" + (" (EMA weights)" if ema else "")
    line = stand_in + line
    print(line)
    return line
