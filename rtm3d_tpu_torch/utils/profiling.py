"""Tracing utilities.

Port of ``rtm3d_tpu/utils/profiling.py``. The reference times with
wall-clock prints (detect.py:55-60, train_multi_gpu.py:173-199). Here:

- ``device_trace(logdir)``: the counterpart of ``xla_trace``, a
  ``torch.profiler`` capture of CPU and, where there is a GPU, CUDA
  activity, written as a Chrome trace (``chrome://tracing`` or Perfetto)
  under ``logdir``; no TensorBoard import;
- ``span(name)``: a ``record_function`` at a layer boundary of the hot
  path, entered only while a profiler records. The profiler puts it and
  the device's kernels on one timeline, so a kernel is put down to the
  span its launch fell in, and an idle gap of the device to the span the
  host was in. A span's parent is the span around it on its thread; the
  root span of a call (``detect.call``) or a step (``train.step``) is what
  the spans of one call share;
- ``count(name, n)`` and ``counters``: process-wide counts taken at the
  same boundaries, under the same condition. ``host_syncs``: each point
  of the hot path where the host waits for the device, reading a result
  back (``.cpu()``, ``.tolist()``) or copying a host tensor or list to it
  (a copy that is not ``non_blocking`` waits for the stream first).

With no profiler a span costs one flag read and enters nothing: nothing
reaches ``torch.ops.profiler``, so a ``torch.export`` graph holds no span,
and no counter moves.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import Counter

import torch
from torch.autograd import profiler as _profiler
from torch.autograd.profiler import record_function

counters: Counter = Counter()
_OFF = contextlib.nullcontext()


def span(name: str):
    """``with span("net.backbone"): ...``: a ``record_function`` while a
    profiler records, else a context that does nothing."""
    if _profiler._is_profiler_enabled:  # read at each call: the profiler sets it
        return record_function(name)
    return _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to ``counters[name]`` while a profiler records."""
    if _profiler._is_profiler_enabled:
        counters[name] += n


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
