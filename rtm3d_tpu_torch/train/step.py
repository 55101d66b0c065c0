"""The detect step: normalise -> network -> decode -> 3D recovery.

Port of the detect half of ``rtm3d_tpu/train/step.py`` (``normalize_images``
:35-44, ``attach_3d`` :237-255, ``make_detect_step`` :258-309); reference
semantics: detect.py:47-88. Training comes with a later slice (ROADMAP.md).

Public layouts are the JAX package's: images (B, H, W, 3) uint8 or
normalised float, K (B, 3, 3), and a dict of fixed (B, K, ...) tensors with
the same keys as the JAX step. Inside, the network runs channels_last.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict

import torch
from torch import nn

from rtm3d_tpu_torch.config import Config
from rtm3d_tpu_torch.decode.peaks import decode_detections
from rtm3d_tpu_torch.decode.solve3d import solve_bbox3d

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU. With no GPU, raise: the entry points never
    fall back to the CPU unless the caller asks for it (``device="cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def compute_dtype(cfg: Config) -> torch.dtype:
    name = str(cfg.TPU.COMPUTE_DTYPE)
    if name not in _DTYPES:
        raise ValueError(f"TPU.COMPUTE_DTYPE {name!r} is not one of {sorted(_DTYPES)}")
    return _DTYPES[name]


def normalize_images(imgs: torch.Tensor, cfg: Config) -> torch.Tensor:
    """uint8 batches are normalised on the device: (x/255 - mean)/std.
    Float inputs pass through (already normalised by the host pipeline,
    reference Normalize transforms.py:110-120)."""
    if imgs.dtype == torch.uint8:
        mean = torch.tensor(cfg.DATASET.MEAN, dtype=torch.float32, device=imgs.device)
        std = torch.tensor(cfg.DATASET.STD, dtype=torch.float32, device=imgs.device)
        return (imgs.float() / 255.0 - mean) / std
    return imgs


def attach_3d(det: Dict[str, torch.Tensor], K: torch.Tensor, cfg: Config) -> Dict[str, torch.Tensor]:
    """Complete a decoded detection dict with the 3D recovery: batched LM
    solve from the regressed vertices + residual acceptance
    (reference optim_decode_bbox3d, model_utils.py:264-312)."""
    topk = det["v_proj"].shape[1]
    Kb = K[:, None].expand(K.shape[0], topk, 3, 3)
    sol = solve_bbox3d(
        det["v_proj"], det["cls"], Kb,
        cfg.DETECTOR.dim_ref, cfg.DETECTOR.REF_LOC,
        iters=int(cfg.DETECTOR.SOLVER_ITERS),
        prior_weight=float(cfg.DETECTOR.get("DIM_PRIOR_WEIGHT", 0.0)),
    )
    det = dict(det)
    det.update(sol)
    det["accepted"] = det["valid"] & (sol["cost"] < float(cfg.DETECTOR.RESIDUAL_THRESH))
    return det


def make_detect_step(
    model: nn.Module, cfg: Config, with_3d: bool = True, device=None
) -> Callable[[torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]]:
    """detect_step(images, K) -> detections dict.

    The step holds its own copy of ``model`` on ``device`` (the GPU when
    None), in eval mode, channels_last and cast to ``TPU.COMPUTE_DTYPE`` —
    parameters and BN statistics alike, as the JAX step casts its variables.
    Decode and the 3D solver run in fp32 on the upcast logits. Inputs on
    another device are copied to ``device``. Returns fixed (B, TOPK)
    tensors; ``accepted`` combines the score threshold with the solver's
    residual acceptance (model_utils.py:298).
    """
    device = resolve_device(device)
    dtype = compute_dtype(cfg)
    net = copy.deepcopy(model).to(device=device, dtype=dtype, memory_format=torch.channels_last)
    net.eval()
    topk = int(cfg.DETECTOR.TOPK_CANDIDATES)
    thresh = float(cfg.DETECTOR.SCORE_THRESH)
    down = float(cfg.MODEL.DOWN_SAMPLE)

    @torch.inference_mode()
    def detect_step(images, K):
        images = torch.as_tensor(images).to(device, non_blocking=True)
        K = torch.as_tensor(K, dtype=torch.float32).to(device, non_blocking=True)
        # NHWC -> an NCHW view with channels_last strides: no copy
        x = normalize_images(images, cfg).permute(0, 3, 1, 2).to(dtype)
        logits = net(x)
        det = decode_detections(logits, score_thresh=thresh, topk=topk, down_sample=down)
        if with_3d:
            return attach_3d(det, K, cfg)
        det["accepted"] = det["valid"]
        return det

    return detect_step
