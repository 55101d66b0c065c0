"""Train state: fp32 master model, optimizer, schedule, step, optional EMA.

Port of ``rtm3d_tpu/train/state.py:12-40``. The JAX state is an immutable
pytree of params, batch stats and optimizer state; here the master model
(``nn.Module``, fp32 parameters and BN buffers) and the ``torch.optim``
optimizer hold them, and the train step updates them in place (no second
copy of the weights per step).

``ema`` is a shadow copy of the parameters (module.py:71-119 parity), a
``{name: tensor}`` dict, or None. As in the JAX package it covers the
parameters only: BN statistics are shared. ``eval_variables`` prefers it
(the reference's CheckPointer prefers the EMA model, check_point.py:122).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import torch
from torch import nn

from rtm3d_tpu_torch.config import Config
from rtm3d_tpu_torch.train.optim import build_optimizer
from rtm3d_tpu_torch.train.step import resolve_device


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0  # train_step calls so far
    updates: int = 0  # optimizer updates so far (fewer than ``step`` under accumulation)
    accumulate_steps: int = 1
    ema: Optional[Dict[str, torch.Tensor]] = field(default=None)

    @classmethod
    def create(cls, model: nn.Module, cfg: Config, device=None, with_ema: bool | None = None,
               max_iters: int | None = None) -> "TrainState":
        """A state over a copy of ``model`` on ``device`` (the GPU when None;
        fp32, channels_last). ``with_ema`` defaults to ``cfg.TRAINING.EMA``."""
        device = resolve_device(device)
        net = copy.deepcopy(model).to(device=device, dtype=torch.float32,
                                      memory_format=torch.channels_last)
        net.train()
        optimizer, schedule = build_optimizer(cfg, net, max_iters)
        if with_ema is None:
            with_ema = bool(cfg.TRAINING.get("EMA", False))
        ema = {k: p.detach().clone() for k, p in net.named_parameters()} if with_ema else None
        return cls(net, optimizer, schedule,
                   accumulate_steps=int(cfg.SOLVER.get("ACCUMULATE_STEPS", 1) or 1), ema=ema)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def eval_variables(self) -> Dict[str, torch.Tensor]:
        """Parameters (the EMA shadow when tracked) and buffers, by name:
        what the eval-loss step and a detector evaluate."""
        tensors = dict(self.model.named_buffers())
        tensors.update(self.ema if self.ema is not None else
                       {k: p.detach() for k, p in self.model.named_parameters()})
        return tensors
