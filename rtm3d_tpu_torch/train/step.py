"""The train, eval-loss and detect steps.

Port of ``rtm3d_tpu/train/step.py``: ``normalize_images`` (:35-44),
``_loss_from_batch``, ``make_train_step`` and ``make_eval_loss_step``
(:95-234), ``attach_3d``, ``make_detect_step`` (:237-309) and
``make_detect_step_from_export`` (:312-350); reference semantics:
train.py:61-117 and detect.py:47-88.

Public layouts are the JAX package's: images (B, H, W, 3) uint8 or
normalised float, a label block of fixed (B, MAX_OBJS, ...) tensors
(``data/targets.py::LABEL_KEYS``), K (B, 3, 3), and dicts with the JAX
steps' keys. Inside, the network runs channels_last (NCHW logits).

The train and eval-loss steps build their targets on the device, inside
the step, with the splat kernel (``ops/splat.py``). Their input stage,
``prepare_images`` (step.py:47-92), takes the loader's three batch forms:
uint8 or normalised frames; raw canvases with ``warp`` (and ``photo``,
``border``) scalars, warped on the device by ``ops/device_warp.py``; or,
with the device dataset cache, ``image_idx`` rows gathered from it.

Mixed precision differs from the JAX step in form: the JAX step casts
params and BN statistics to ``TPU.COMPUTE_DTYPE`` and re-promotes the new
statistics (step.py:110-139); the port keeps fp32 masters and runs
forward and backward under ``torch.autocast(dtype=torch.bfloat16)``. So
under bf16 BatchNorm keeps fp32 weights and running statistics and
reduces in fp32, and the KFPN softmax runs in fp32 (autocast promotes
it), where the JAX step ran both in bf16. Parity is held at fp32.

``TPU.REMAT``: the train step runs the network as checkpointed segments,
one per backbone stage, the KFPN fusion and one per header branch
(``nn/model.py``), with the BatchNorms guarded so that the recompute
neither counts nor folds the batch again (``nn/layers.py::
remat_segment``): the same numbers as without it, less activation
memory. The JAX step checkpoints its whole forward as one segment
(step.py:141-142); in eager PyTorch a single segment would hold every
activation again while it recomputes. The eval-loss and detect steps
never checkpoint.

The spatial mesh axis (``parallel/spatial.py``): with ``S > 1`` ranks on
it, each rank of a data group builds its group's full targets (the splat
kernel on the whole map) and its full frames (the device warp, the cache
gather and the photometric noise, seeded from the batch's seed column and
so the same on every rank of the group), then keeps its band of the
frames' rows and of the heatmap target. The model runs on the band under
the step's ``Grid`` (``spatial.attached``, over the forward and the
backward, so that a REMAT recompute exchanges its halos again, in the
same order on every rank), and the loss counts each centre and vertex on
the rank whose band holds it. The gradient all-reduce and its divisor,
the world size, are the data-parallel ones: every rank's pieces of the
global batch are disjoint. ``num_targets`` is summed over the data axis
only, once per object. Adamax and the EMA are unchanged: the state is
the same on every rank.

Left out (ROADMAP.md): ``TPU.DONATE`` (no meaning in eager PyTorch: the
step updates the state in place).
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
from rtm3d_tpu_torch.nn.model import deepest_stride
from rtm3d_tpu_torch.ops.device_warp import device_warp
from rtm3d_tpu_torch.parallel.dist import all_reduce_sum, data_group, world_size
from rtm3d_tpu_torch.parallel.spatial import attached, frame_grid

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


def prepare_images(batch: dict, cfg: Config, image_cache: torch.Tensor | None = None) -> torch.Tensor:
    """The device-side input stage: (B, H, W, 3) float32 normalised frames.

    With ``image_idx`` the frames are rows of ``image_cache``, the device
    dataset cache (``index_select``), else ``batch['image']``. With
    ``warp`` the frames are raw canvases: first the photometric step when
    the batch carries ``photo`` (B, 4: alpha, beta, std, seed), ``x *
    alpha + beta * 255`` plus N(0, std) noise, clipped to [0, 255]; then
    ``ops/device_warp.py::device_warp`` to ``INPUT_SIZE`` with the border
    colour ``border``. Without ``warp``, the uint8 normalisation.

    The noise is one draw for the whole batch from a ``torch.Generator`` on
    the frames' device, seeded from the batch's seed column and scaled by
    each lane's std: lanes are disjoint slices of the draw, so two lanes
    whose host seeds are equal still differ, and a lane with std 0 gets
    none. Torch's stream is not JAX's: the noise matches the JAX step's in
    distribution only. Reading the seeds waits for the batch's (small)
    ``photo`` tensor."""
    if "image_idx" in batch:
        if image_cache is None:
            raise ValueError("the batch carries image_idx but no image_cache was given")
        imgs = image_cache.index_select(0, batch["image_idx"].to(image_cache.device, torch.long))
    else:
        imgs = batch["image"]
    if "warp" not in batch:
        return normalize_images(imgs, cfg)
    if "photo" in batch:
        ph = batch["photo"].to(torch.float32)
        x = imgs.to(torch.float32) * ph[:, 0, None, None, None] + ph[:, 1, None, None, None] * 255.0
        seed = 0
        for s in ph[:, 3].tolist():
            seed = (seed * 1000003 + int(s)) % (2**63)
        gen = torch.Generator(device=x.device).manual_seed(seed)
        x += torch.randn(x.shape, generator=gen, device=x.device) * ph[:, 2, None, None, None]
        imgs = x.clamp_(0.0, 255.0)
    w, h = int(cfg.INPUT_SIZE[0]), int(cfg.INPUT_SIZE[1])
    return device_warp(imgs, batch["warp"], (h, w), cfg.DATASET.MEAN, cfg.DATASET.STD, border=batch.get("border"))


def _to_device(batch: dict, device: torch.device) -> dict:
    """The batch's arrays and tensors, nested dicts included, on
    ``device``; the loader's ``path`` list stays on the host."""
    return {
        k: _to_device(v, device) if isinstance(v, dict)
        else v if k == "path" else torch.as_tensor(v).to(device, non_blocking=True)
        for k, v in batch.items()
    }


def _check_state(state, device: torch.device) -> None:
    got = state.device
    if got.type != device.type or (device.index is not None and got.index != device.index):
        raise ValueError(f"the train state lives on {got}, the step runs on {device}")


def _grid(cfg: Config):
    """The spatial grid of ``cfg``'s frames on this rank, None without one."""
    return frame_grid(int(cfg.INPUT_SIZE[1]), deepest_stride(cfg))


def _loss_from_batch(net: nn.Module, cfg: Config, batch: dict, sample_mask=None, variables=None,
                     image_cache=None, remat: bool = False, grid=None):
    """(loss, aux) of ``net`` on ``batch``, targets built on the device.
    ``variables``: parameters and buffers to evaluate in place of the
    module's own (``torch.func.functional_call``); ``image_cache``: the
    device dataset cache ``prepare_images`` gathers from; ``remat``: the
    forward as checkpointed segments (``TPU.REMAT``, training only);
    ``grid``: this rank's band of the spatial axis (``_grid``), attached to
    ``net`` by the caller, or None."""
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
    x = prepare_images(batch, cfg, image_cache).permute(0, 3, 1, 2)
    rows = None
    if grid is not None:  # this rank's band of the frames and of the heatmap target
        a, b = grid.band
        if x.shape[2] != grid.bands[-1][1]:
            raise ValueError(f"the frames have {x.shape[2]} rows, the grid's bands {grid.bands}")
        d = int(cfg.MODEL.DOWN_SAMPLE)
        x = x[:, :, a:b].contiguous(memory_format=torch.channels_last)
        rows = (a // d, b // d, targets["m_hm"].shape[2])
        targets = dict(targets, m_hm=targets["m_hm"][:, :, rows[0]:rows[1]])
    dtype = compute_dtype(cfg)
    with torch.autocast(x.device.type, dtype=dtype, enabled=dtype != torch.float32):
        logits = net(x, remat=remat) if variables is None else torch.func.functional_call(net, variables, (x,))
    t = cfg.TRAINING
    return rtm3d_loss(
        logits, targets,
        w_mkf=t.W_MKF, w_vfm=t.W_VFM, w_m_off=t.W_M_OFF, w_v_off=t.W_V_OFF,
        focal_alpha=cfg.MODEL.FOCAL_LOSS_ALPHA, focal_beta=cfg.MODEL.FOCAL_LOSS_BEDA,
        sample_mask=sample_mask, rows=rows,
    )


def _average_over_ranks(grads, divisor: int) -> None:
    """Each gradient summed over the ranks and divided by ``divisor``, in
    place: one ``all_reduce`` of the gradients flattened into one buffer."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_sum(flat).div_(divisor)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view(g.shape))
        offset += g.numel()


def make_train_step(cfg: Config, device=None) -> Callable:
    """Returns ``train_step(state, batch, image_cache=None) -> (state, metrics)``.

    ``state`` is a ``train.state.TrainState`` on ``device`` (the GPU when
    None); the step updates it in place and returns it. ``batch``:
    {'image': (B,H,W,3) uint8 or float, 'labels': {cls, bbox, dim, alpha, ry,
    loc, K, mask, noise_mask} padded to MAX_OBJS}, or a raw-mode batch (see
    ``prepare_images``; ``image_cache`` is the device dataset cache); arrays
    on another device are copied to ``device``. metrics: {'loss', 'loss_items' [MKF, VFM,
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

    Under a process group of W > 1 ranks (``parallel/dist.py``) each rank
    passes its own rows of the global batch, and the step is the JAX
    step's on the global batch: BatchNorm takes the global batch's
    statistics, the loss divides by global counts (``rtm3d_loss``), and
    on the k-th call the gradients are averaged over the ranks by one
    ``all_reduce`` of a flat buffer (not DDP: that would need
    ``find_unused_parameters`` for the gradients the forward never makes,
    ``no_sync`` for accumulation, and a wrapper around the model; with no
    overlap of the reduction and the backward to gain on one card, one
    reduction after ``backward`` is the simpler). Every rank then applies
    the same update to the same parameters, and the metrics are the
    global batch's on every rank.
    """
    device = resolve_device(device)
    compute_dtype(cfg)  # validate before the first step
    decay = float(cfg.TRAINING.get("EMA_DECAY", 0.9999))
    remat = bool(cfg.TPU.get("REMAT", False))

    def train_step(state, batch, image_cache=None):
        _check_state(state, device)
        net, opt, k = state.model, state.optimizer, state.accumulate_steps
        ranks = world_size()
        net.train()
        batch = _to_device(batch, device)
        if state.step % k == 0:
            opt.zero_grad(set_to_none=True)
        grid = _grid(cfg)
        with attached(net, grid):  # over the backward too: a REMAT recompute runs on the band
            loss, aux = _loss_from_batch(net, cfg, batch, image_cache=image_cache, remat=remat, grid=grid)
            loss.backward()
        if (state.step + 1) % k == 0:
            grads = []
            for group in opt.param_groups:
                for p in group["params"]:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                    elif k > 1 and ranks == 1:
                        p.grad.div_(k)
                    grads.append(p.grad)
            if ranks > 1:
                _average_over_ranks(grads, ranks * k)
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
            "loss": aux[4],
            "loss_items": aux,
            # once per object: the ranks of a data group hold the same labels
            "num_targets": all_reduce_sum(batch["labels"]["mask"].sum(), group=data_group()),
        }
        return state, metrics

    return train_step


def make_eval_loss_step(cfg: Config, device=None) -> Callable:
    """Returns ``eval_step(state, batch, image_cache=None, num_valid=None) -> {'loss', 'loss_items'}``:
    the eval-mode loss (reference test_epoch, train.py:61-81) on the EMA
    shadow when one is tracked (check_point.py:122), BN on its running
    statistics. Rows where ``batch['sample_valid']`` is False, or rows
    ``>= num_valid``, are left out of every sum and count, so a padded
    final batch scores as its valid rows alone. Under a process group the
    loss is the global batch's, every rank's valid rows."""
    device = resolve_device(device)
    compute_dtype(cfg)

    def eval_step(state, batch, image_cache=None, num_valid=None):
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
        grid = _grid(cfg)
        try:
            with torch.no_grad(), attached(net, grid):
                loss, aux = _loss_from_batch(net, cfg, batch, sample_mask, state.eval_variables(), image_cache,
                                             grid=grid)
        finally:
            net.train(was_training)
        return {"loss": aux[4], "loss_items": aux}

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


def _detect_inputs(images, K, warp, border, cfg: Config, device: torch.device):
    """The detect steps' input stage on ``device``: (B, H, W, 3) normalised
    frames (the device warp's, with ``warp``; uint8 frames normalised,
    float frames as they are) and float32 K."""
    images = torch.as_tensor(images).to(device, non_blocking=True)
    K = torch.as_tensor(K, dtype=torch.float32).to(device, non_blocking=True)
    if warp is not None:
        batch = {"image": images, "warp": torch.as_tensor(warp).to(device, non_blocking=True)}
        if border is not None:
            batch["border"] = torch.as_tensor(border).to(device, non_blocking=True)
        images = prepare_images(batch, cfg)
    return normalize_images(images, cfg), K


def make_detect_step(
    model: nn.Module, cfg: Config, with_3d: bool = True, device=None
) -> Callable[..., Dict[str, torch.Tensor]]:
    """detect_step(images, K, warp=None, border=None) -> detections dict.

    The step holds its own copy of ``model`` on ``device`` (the GPU when
    None), in eval mode, channels_last and cast to ``TPU.COMPUTE_DTYPE`` —
    parameters and BN statistics alike, as the JAX step casts its variables.
    With ``warp`` (B, 6) the images are raw uint8 canvases, resampled to
    ``INPUT_SIZE`` and normalised by ``ops/device_warp.py`` with the border
    colour ``border`` (the device-warp raw mode, ``TPU.DEVICE_WARP``; no
    photometric step); else uint8 frames are normalised and float frames
    pass. Decode and the 3D solver run in fp32 on the upcast logits. Inputs
    on another device are copied to ``device``. Returns fixed (B, TOPK)
    tensors; ``accepted`` combines the score threshold with the solver's
    residual acceptance (model_utils.py:298); with ``with_3d`` False (the
    int8 default) ``accepted`` is ``valid`` and no 3D keys are returned.

    An int8 network (``nn/quant.py::quantize_model``) is served the same
    way: its ``QuantConv`` modules quantize the copy's weights after the
    cast, so under bf16 the weight scales come from the bf16 kernels, as
    the JAX step casts its variables before the apply (step.py:285-293).
    """
    device = resolve_device(device)
    dtype = compute_dtype(cfg)
    net = copy.deepcopy(model).to(device=device, dtype=dtype, memory_format=torch.channels_last)
    net.eval()  # frames whole: the spatial axis replicates serving (parallel/mesh.py:147-158)
    topk = int(cfg.DETECTOR.TOPK_CANDIDATES)
    thresh = float(cfg.DETECTOR.SCORE_THRESH)
    down = float(cfg.MODEL.DOWN_SAMPLE)

    @torch.inference_mode()
    def detect_step(images, K, warp=None, border=None):
        images, K = _detect_inputs(images, K, warp, border, cfg, device)
        # NHWC -> an NCHW view with channels_last strides: no copy
        logits = net(images.permute(0, 3, 1, 2).to(dtype))
        det = decode_detections(logits, score_thresh=thresh, topk=topk, down_sample=down)
        if with_3d:
            return attach_3d(det, K, cfg)
        det["accepted"] = det["valid"]
        return det

    return detect_step


def make_detect_step_from_export(exported, cfg: Config, device=None) -> Callable[..., Dict[str, torch.Tensor]]:
    """detect_step(images, K, warp=None, border=None) -> detections dict,
    around an artifact of ``cli/export.py`` (``load_exported``, on
    ``device``, the GPU when None): no model is built and no weights are
    loaded. Normalise or the device warp, as ``make_detect_step``; then
    the artifact on the float32 NHWC frames; decode here when the artifact
    is logits-only; then ``attach_3d``, the LM kernel's two launches (the
    artifact leaves the solve out, as the JAX artifact does)."""
    device = resolve_device(device)
    if exported.device != device:
        raise ValueError(f"the artifact is loaded on {exported.device}, the step runs on {device}")
    topk = int(cfg.DETECTOR.TOPK_CANDIDATES)
    thresh = float(cfg.DETECTOR.SCORE_THRESH)
    down = float(cfg.MODEL.DOWN_SAMPLE)

    @torch.inference_mode()
    def detect_step(images, K, warp=None, border=None):
        images, K = _detect_inputs(images, K, warp, border, cfg, device)
        out = exported(images.to(torch.float32))
        if isinstance(out, dict):  # a --with-decode artifact
            det = dict(out)
        else:
            det = decode_detections(out, score_thresh=thresh, topk=topk, down_sample=down)
        return attach_3d(det, K, cfg)

    return detect_step
