"""High-level library API.

Port of ``rtm3d_tpu/api.py:28-90``: one object over config + model + the
detect step, for users embedding the detector.

    from rtm3d_tpu_torch.api import Detector

    det = Detector(cfg, state_dict)        # on the GPU; device="cpu" to opt out
    out = det(images_uint8_nhwc, K)        # fixed (B, K) numpy arrays + masks
    objs = det.to_objects(out)             # per-image python lists
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
from torch import nn

from rtm3d_tpu_torch.config import Config, load_config
from rtm3d_tpu_torch.nn.model import create_model
from rtm3d_tpu_torch.train.checkpoint import load_detect_weights
from rtm3d_tpu_torch.train.step import make_detect_step


class Detector:
    """``state_dict_or_model``: an ``RTM3D`` module, or a state_dict with the
    reference names, loaded strict. ``device`` None means the GPU; with no
    GPU the constructor raises."""

    def __init__(
        self,
        cfg: Config,
        state_dict_or_model,
        device=None,
        with_3d: bool = True,
    ):
        self.cfg = cfg
        if isinstance(state_dict_or_model, nn.Module):
            model = state_dict_or_model
        elif isinstance(state_dict_or_model, Mapping):
            model = create_model(cfg)
            model.load_state_dict(state_dict_or_model, strict=True)
        else:
            raise TypeError("Detector takes an nn.Module or a state_dict")
        self._detect = make_detect_step(model, cfg, with_3d=with_3d, device=device)
        self.class_names: Sequence[str] = list(cfg.DATASET.OBJs)

    @classmethod
    def from_config(
        cls,
        yaml_path: str,
        checkpoint: Optional[str] = None,
        overrides: Optional[list] = None,
        input_size: Optional[tuple] = None,
        with_3d: bool = True,
        device=None,
    ) -> "Detector":
        """Build from a YAML config and a checkpoint (``checkpoint`` or
        ``DETECTOR.CHECKPOINT``), read by ``train.checkpoint.
        load_detect_weights``: a flax msgpack file of the JAX package (its
        EMA preferred), a ``CheckPointer`` file of the port (its EMA), or a
        reference ``.pt`` (suffix-matched). A path that does not exist
        leaves random weights, with a warning, as in the JAX package."""
        cfg = load_config(yaml_path, overrides)
        if input_size is not None:
            cfg.INPUT_SIZE = tuple(input_size)
        model = create_model(cfg)
        load_detect_weights(checkpoint or cfg.DETECTOR.CHECKPOINT, model)
        return cls(cfg, model, device=device, with_3d=with_3d)

    def __call__(self, images, K, warp=None, border=None) -> Dict[str, np.ndarray]:
        """images: (B, H, W, 3) uint8 or normalised float32 (numpy or
        tensor); K: (B, 3, 3) intrinsics in the same frame. With ``warp``
        (B, 6) and ``border`` (B, 3) the images are raw canvases the step
        resamples on the device (the device-warp raw mode). Returns host
        numpy arrays."""
        out = self._detect(images, K, warp=warp, border=border)
        return {k: v.cpu().numpy() for k, v in out.items()}

    def to_objects(self, det: Dict[str, np.ndarray]) -> List[List[dict]]:
        """Unpack fixed arrays into per-image lists of accepted detections."""
        out = []
        B = det["cls"].shape[0]
        for b in range(B):
            objs = []
            for i in np.where(det["accepted"][b])[0]:
                h, w, l = (float(v) for v in det["dim"][b, i])
                x, y, z = (float(v) for v in det["loc"][b, i])
                objs.append(
                    {
                        "class": self.class_names[int(det["cls"][b, i])],
                        "score": float(det["scores"][b, i]),
                        "bbox2d": det["bbox2d"][b, i].tolist(),
                        "dim": [h, w, l],
                        # KITTI bottom-center convention (solver Y is center)
                        "loc": [x, y + h / 2, z],
                        "ry": float(det["ry"][b, i]),
                        "residual": float(det["cost"][b, i]) if "cost" in det else None,
                    }
                )
            out.append(objs)
        return out
