"""Optimizer and LR schedules, with the reference solver's semantics.

Port of ``rtm3d_tpu/train/optim.py:39-186``; reference:
solver/OptimizerBuilder.py:13-36 (per-parameter groups, Adamax with
coupled L2 weight decay) and solver/lr_scheduler.py (detectron2-style
warmup multistep / cosine, stepped every iteration, Solver.py:99).

The JAX package writes torch's Adamax by hand; the port uses
``torch.optim.Adamax`` itself, one param group per group label, each
with its weight decay (coupled: ``g += wd * p``) and its lr factor. The
train step sets each group's lr to ``factor * schedule(t)`` before update
t (0-based), as the JAX package evaluates the schedule at ``count - 1``.

Group policy, the JAX package's (``optim.py:94-107``): BatchNorm weight and
bias -> "norm" (WEIGHT_DECAY_NORM); any other bias -> "bias"
(WEIGHT_DECAY_BIAS, lr x BIAS_LR_FACTOR); everything else -> "weight"
(WEIGHT_DECAY); names under an EXCLUDE_SCOPE prefix -> "frozen" (no
gradient, no update). The JAX package classifies flax paths (a ``scale``
leaf, or a ``bias`` under a module whose name holds ``bn``/``norm``); the
port classifies by module type, which gives every parameter the group of
the flax leaf that ``train/checkpoint.py::_to_dotted`` maps onto it
(``tests/test_torch_train.py`` holds that key by key). EXCLUDE_SCOPE
entries are prefixes of the port's dotted names, ``/`` read as ``.``; the
top-level modules (``backbone``, ``kfpn_fusion``, ``detect_header``) carry
the same names in both packages.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence

import torch
from torch import nn

from rtm3d_tpu_torch.config import Config

GROUPS = ("weight", "bias", "norm")


def warmup_factor_at(step: int, method: str, warmup_iters: int, warmup_factor: float) -> float:
    """lr_scheduler.py:90-116."""
    if step >= warmup_iters:
        return 1.0
    if method == "constant":
        return warmup_factor
    if method == "linear":
        alpha = step / max(warmup_iters, 1)
        return warmup_factor * (1 - alpha) + alpha
    raise ValueError(f"unknown warmup method {method}")


def warmup_multistep_schedule(base_lr, steps, gamma, warmup_factor, warmup_iters,
                              method="linear") -> Callable[[int], float]:
    """lr = base * warmup(iter) * gamma^(#milestones passed) (lr_scheduler.py:16-50)."""
    milestones = sorted(steps)

    def schedule(step: int) -> float:
        passed = sum(step >= m for m in milestones)
        return base_lr * warmup_factor_at(step, method, warmup_iters, warmup_factor) * gamma**passed

    return schedule


def warmup_cosine_schedule(base_lr, max_iters, warmup_factor, warmup_iters,
                           method="linear") -> Callable[[int], float]:
    """lr = base * warmup(iter) * 0.5 * (1 + cos(pi * iter / max)) (lr_scheduler.py:52-87)."""

    def schedule(step: int) -> float:
        wf = warmup_factor_at(step, method, warmup_iters, warmup_factor)
        return base_lr * wf * 0.5 * (1.0 + math.cos(math.pi * step / max_iters))

    return schedule


def build_lr_schedule(cfg: Config, max_iters: int | None = None) -> Callable[[int], float]:
    """Dispatch by SOLVER.LR_SCHEDULER_NAME (OptimizerBuilder.py:39-64)."""
    s = cfg.SOLVER
    if s.LR_SCHEDULER_NAME == "WarmupMultiStepLR":
        return warmup_multistep_schedule(
            s.BASE_LR, tuple(s.STEPS), s.GAMMA, s.WARMUP_FACTOR, s.WARMUP_ITERS, s.WARMUP_METHOD
        )
    if s.LR_SCHEDULER_NAME == "WarmupCosineLR":
        return warmup_cosine_schedule(
            s.BASE_LR, max_iters or s.get("MAX_ITER", 100000), s.WARMUP_FACTOR, s.WARMUP_ITERS,
            s.WARMUP_METHOD,
        )
    raise ValueError(f"Unknown LR scheduler: {s.LR_SCHEDULER_NAME}")


def param_groups(model: nn.Module, exclude_scopes: Sequence[str] = ()) -> Dict[str, str]:
    """{parameter name: 'weight' | 'bias' | 'norm' | 'frozen'}."""
    scopes = tuple(s.replace("/", ".") for s in exclude_scopes)
    out = {}
    for mod_name, mod in model.named_modules():
        for leaf, _ in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            if any(name.startswith(scope) for scope in scopes):
                out[name] = "frozen"
            elif isinstance(mod, nn.modules.batchnorm._BatchNorm):
                out[name] = "norm"
            elif leaf == "bias":
                out[name] = "bias"
            else:
                out[name] = "weight"
    return out


def build_optimizer(cfg: Config, model: nn.Module, max_iters: int | None = None):
    """Returns (torch.optim.Adamax over ``model``'s parameters, lr schedule).

    Frozen parameters get ``requires_grad = False`` and stay out of the
    optimizer. Each param group carries ``lr_factor``; the train step sets
    ``lr = lr_factor * schedule(t)``."""
    s = cfg.SOLVER
    groups = param_groups(model, tuple(s.EXCLUDE_SCOPE))
    decay = {"weight": s.WEIGHT_DECAY, "bias": s.WEIGHT_DECAY_BIAS, "norm": s.WEIGHT_DECAY_NORM}
    factor = {"weight": 1.0, "bias": s.BIAS_LR_FACTOR, "norm": 1.0}
    members = {g: [] for g in GROUPS}
    for name, p in model.named_parameters():
        if groups[name] == "frozen":
            p.requires_grad_(False)
        else:
            members[groups[name]].append(p)
    schedule = build_lr_schedule(cfg, max_iters)
    lr0 = schedule(0)
    opt = torch.optim.Adamax(
        [
            {"params": members[g], "weight_decay": float(decay[g]),
             "lr_factor": float(factor[g]), "lr": lr0 * float(factor[g])}
            for g in GROUPS if members[g]
        ],
        lr=lr0, betas=(0.9, 0.999), eps=1e-8,
    )
    return opt, schedule
