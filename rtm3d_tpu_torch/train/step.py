"""The train, eval-loss and detect steps.

Port of ``rtm3d_tpu/train/step.py``: ``normalize_images`` (:35-44),
``_loss_from_batch``, ``make_train_step`` and ``make_eval_loss_step``
(:95-234), ``attach_3d`` and ``make_detect_step`` (:237-309); reference
semantics: train.py:61-117 and detect.py:47-88.

Public layouts are the JAX package's: images (B, H, W, 3) uint8 or
normalised float, a label block of fixed (B, MAX_OBJS, ...) tensors
(``data/targets.py::LABEL_KEYS``), K (B, 3, 3), and dicts with the JAX
steps' keys. Inside, the network runs channels_last (NCHW logits).

The train and eval-loss steps build their targets on the device, inside
the step, with the splat kernel (``ops/splat.py``). Mixed precision
differs from the JAX step in form: the JAX step casts params and BN
statistics to ``TPU.COMPUTE_DTYPE`` and re-promotes the new statistics
(step.py:110-139); the port keeps fp32 masters and runs forward and
backward under ``torch.autocast(dtype=torch.bfloat16)``. So under bf16
BatchNorm keeps fp32 weights and running statistics and reduces in fp32,
and the KFPN softmax runs in fp32 (autocast promotes it), where the JAX
step ran both in bf16. Parity is held at fp32.

Left out (ROADMAP.md): the device-warp and photometric input modes
(step.py:47-92), the device dataset cache, ``TPU.REMAT`` (a
``torch.utils.checkpoint`` re-run of the forward would update the BN
running statistics a second time, which ``jax.checkpoint`` does not) and
``TPU.DONATE`` (no meaning in eager PyTorch: the step updates the state in
place).
"""

from __future__ import annotations

import copy
import math
from typing import Callable, Dict

import torch
from torch import nn

from rtm3d_tpu_torch.config import Config
from rtm3d_tpu_torch.data.targets import build_targets
from rtm3d_tpu_torch.decode.peaks import decode_detections
from rtm3d_tpu_torch.decode.solve3d import solve_bbox3d
from rtm3d_tpu_torch.losses.rtm3d_loss import rtm3d_loss

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


def _feat_hw(cfg: Config):
    w, h = int(cfg.INPUT_SIZE[0]), int(cfg.INPUT_SIZE[1])
    d = int(cfg.MODEL.DOWN_SAMPLE)
    return h // d, w // d


def _to_device(batch: dict, device: torch.device) -> dict:
    """The batch's arrays and tensors, nested dicts included, on ``device``."""
    return {
        k: _to_device(v, device) if isinstance(v, dict) else torch.as_tensor(v).to(device, non_blocking=True)
        for k, v in batch.items()
    }


def _check_state(state, device: torch.device) -> None:
    got = state.device
    if got.type != device.type or (device.index is not None and got.index != device.index):
        raise ValueError(f"the train state lives on {got}, the step runs on {device}")


def _loss_from_batch(net: nn.Module, cfg: Config, batch: dict, sample_mask=None, variables=None):
    """(loss, aux) of ``net`` on ``batch``, targets built on the device.
    ``variables``: parameters and buffers to evaluate in place of the
    module's own (``torch.func.functional_call``)."""
    targets = build_targets(
        batch["labels"],
        _feat_hw(cfg),
        len(cfg.DATASET.OBJs),
        down_ratio=float(cfg.MODEL.DOWN_SAMPLE),
        gaussian_gen_type=cfg.DATASET.GAUSSIAN_GEN_TYPE,
        bbox_area_max=cfg.DATASET.BBOX_AREA_MAX,
        bbox_area_min=cfg.DATASET.BBOX_AREA_MIN,
    )
    # NHWC -> an NCHW view with channels_last strides: no copy
    x = normalize_images(batch["image"], cfg).permute(0, 3, 1, 2)
    dtype = compute_dtype(cfg)
    with torch.autocast(x.device.type, dtype=dtype, enabled=dtype != torch.float32):
        logits = net(x) if variables is None else torch.func.functional_call(net, variables, (x,))
    t = cfg.TRAINING
    return rtm3d_loss(
        logits, targets,
        w_mkf=t.W_MKF, w_vfm=t.W_VFM, w_m_off=t.W_M_OFF, w_v_off=t.W_V_OFF,
        focal_alpha=cfg.MODEL.FOCAL_LOSS_ALPHA, focal_beta=cfg.MODEL.FOCAL_LOSS_BEDA,
        sample_mask=sample_mask,
    )


def make_train_step(cfg: Config, device=None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``state`` is a ``train.state.TrainState`` on ``device`` (the GPU when
    None); the step updates it in place and returns it. ``batch``:
    {'image': (B,H,W,3) uint8 or float, 'labels': {cls, bbox, dim, alpha, ry,
    loc, K, mask, noise_mask} padded to MAX_OBJS}; arrays on another device
    are copied to ``device``. metrics: {'loss', 'loss_items' [MKF, VFM,
    M_OFF, V_OFF, total], 'num_targets'}, tensors on the device (no sync).

    Per call: targets, forward, backward. With ``SOLVER.ACCUMULATE_STEPS``
    k > 1 the gradients of k calls are summed and, on the k-th call,
    divided by k and applied (optax ``MultiSteps``: the mean of k
    gradients; the schedule advances per applied update). Gradients that
    the forward stops (``stop_bias_grad``) are exact zeros, so coupled weight
    decay still moves those parameters, as in the JAX package. The
    gradients of the last update stay in ``p.grad`` until the next call.
    The EMA shadow, when tracked, moves on every call by
    ``d = EMA_DECAY * (1 - exp(-(step + 1) / 2000))`` (module.py:94).
    """
    device = resolve_device(device)
    compute_dtype(cfg)  # validate before the first step
    decay = float(cfg.TRAINING.get("EMA_DECAY", 0.9999))

    def train_step(state, batch):
        _check_state(state, device)
        net, opt, k = state.model, state.optimizer, state.accumulate_steps
        net.train()
        batch = _to_device(batch, device)
        if state.step % k == 0:
            opt.zero_grad(set_to_none=True)
        loss, aux = _loss_from_batch(net, cfg, batch)
        loss.backward()
        if (state.step + 1) % k == 0:
            for group in opt.param_groups:
                for p in group["params"]:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                    elif k > 1:
                        p.grad.div_(k)
            lr = state.schedule(state.updates)  # update t uses the schedule at t
            for group in opt.param_groups:
                group["lr"] = group["lr_factor"] * lr
            opt.step()
            state.updates += 1
        if state.ema is not None:
            d = decay * (1.0 - math.exp(-(state.step + 1) / 2000.0))
            params = dict(net.named_parameters())
            with torch.no_grad():
                shadow = list(state.ema.values())
                torch._foreach_mul_(shadow, d)
                torch._foreach_add_(shadow, [params[n].detach() for n in state.ema], alpha=1.0 - d)
        state.step += 1
        metrics = {
            "loss": loss.detach(),
            "loss_items": aux,
            "num_targets": batch["labels"]["mask"].sum(),
        }
        return state, metrics

    return train_step


def make_eval_loss_step(cfg: Config, device=None) -> Callable:
    """Returns ``eval_step(state, batch, num_valid=None) -> {'loss', 'loss_items'}``:
    the eval-mode loss (reference test_epoch, train.py:61-81) on the EMA
    shadow when one is tracked (check_point.py:122), BN on its running
    statistics. Rows where ``batch['sample_valid']`` is False, or rows
    ``>= num_valid``, are left out of every sum and count, so a padded
    final batch scores as its valid rows alone."""
    device = resolve_device(device)
    compute_dtype(cfg)

    def eval_step(state, batch, num_valid=None):
        _check_state(state, device)
        batch = _to_device(batch, device)
        sample_mask = batch.get("sample_valid")
        if sample_mask is not None:
            sample_mask = sample_mask.bool()
        if num_valid is not None:
            B = batch["labels"]["mask"].shape[0]
            sample_mask = torch.arange(B, device=device) < int(num_valid)
        net = state.model
        was_training = net.training
        net.eval()
        try:
            with torch.no_grad():
                loss, aux = _loss_from_batch(net, cfg, batch, sample_mask, state.eval_variables())
        finally:
            net.train(was_training)
        return {"loss": loss, "loss_items": aux}

    return eval_step


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
