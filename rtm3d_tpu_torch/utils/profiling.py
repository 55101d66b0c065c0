"""Timing and tracing utilities.

Port of ``rtm3d_tpu/utils/profiling.py``. The reference times with
wall-clock prints (detect.py:55-60, train_multi_gpu.py:173-199). Here:

- ``Timer``: an accumulating named wall-clock timer that waits for the
  device before it reads the clock (the JAX ``Timer`` waits with
  ``jax.block_until_ready(sync)``; this one with
  ``torch.cuda.synchronize`` when ``sync`` names or holds a CUDA device);
- ``device_trace(logdir)``: the counterpart of ``xla_trace``, a
  ``torch.profiler`` capture of CPU and, where there is a GPU, CUDA
  activity, written as a Chrome trace (``chrome://tracing`` or Perfetto)
  under ``logdir``; no TensorBoard import;
- ``device_memory_stats``: the counterpart of ``device_memory_stats``,
  ``torch.cuda.memory_allocated`` per GPU (the reference prints
  ``torch.cuda.memory_cached``, train.py:108).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch


def _cuda_device(sync):
    """The CUDA device ``sync`` names or holds, else None: a device or
    its name, a tensor, or a list, tuple or dict of tensors."""
    if isinstance(sync, (str, torch.device)):
        d = torch.device(sync)
        return d if d.type == "cuda" else None
    if torch.is_tensor(sync):
        return sync.device if sync.is_cuda else None
    items = sync.values() if isinstance(sync, dict) else sync if isinstance(sync, (list, tuple)) else ()
    return next((d for d in map(_cuda_device, items) if d is not None), None)


class Timer:
    """Accumulating named wall-clock timer with device sync."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str, sync=None):
        """Time the block; with ``sync`` on a GPU (a device, a tensor or a
        container of tensors), wait for that device's work first."""
        t0 = time.perf_counter()
        yield
        device = _cuda_device(sync) if sync is not None else None
        if device is not None:
            torch.cuda.synchronize(device)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def summary(self) -> str:
        return " ".join(
            f"{k}={self.totals[k] / max(self.counts[k], 1) * 1e3:.1f}ms" for k in sorted(self.totals)
        )

    def reset(self):
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def device_trace(logdir: str):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA where there
    is a GPU) and write a Chrome trace, ``<logdir>/trace_<pid>_<n>.json``.
    Yields the profiler (``key_averages()`` for a table by kernel)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    with profile(activities=acts, on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
        yield prof


def device_memory_stats() -> Dict[str, int]:
    """Bytes allocated by tensors on each GPU, ``{"cuda:0": n, ...}``;
    empty without a GPU."""
    return {f"cuda:{i}": int(torch.cuda.memory_allocated(i)) for i in range(torch.cuda.device_count())}
