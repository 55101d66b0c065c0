"""A bounded slice of a run under ``torch.profiler``, reduced in memory.

``Slice`` profiles its block (CPU and CUDA activity), marks it with a
``record_function`` of its own, waits for the device on entry and on exit,
and reads the trace into ``summary``:

- ``window_s``: the mark's length on the trace's clock;
- ``busy_s``: the union of the device's kernels, copies and fills inside
  the mark, over every lane (``tools/trace_times.py::summarize``'s rule);
- ``device_ops``: the ten device operations that took most time;
- ``idle_gaps``: the device's idle gaps inside the mark, each named by the
  innermost host event that was running at its middle, summed by name,
  the ten longest;
- ``launches``: the runtime's kernel launches, copies, fills and graph
  launches inside the mark.

The trace goes through one temporary file under ``TMPDIR`` (the profiler
writes no other way), which is deleted once read.
"""

import json
import os
import tempfile
from collections import defaultdict

import torch

MARK = "benchmark.slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
LAUNCH_WORDS = ("LaunchKernel", "Memcpy", "Memset", "GraphLaunch")


def union(intervals) -> list:
    """Sorted disjoint (start, end) pairs covering ``intervals``."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def summarize(events: list, mark: str = MARK) -> dict:
    """The slice's numbers from Chrome-trace ``events`` (microseconds)."""
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == mark and e.get("cat") == "user_annotation"]
    if not spans:
        raise ValueError(f"the trace holds no {mark!r} mark")
    t0 = float(spans[0]["ts"])
    t1 = t0 + float(spans[0]["dur"])
    dev, ops = [], defaultdict(float)
    host, launches = [], 0
    for e in events:
        if e.get("ph") != "X":
            continue
        a = float(e.get("ts", 0.0))
        b = a + float(e.get("dur", 0.0))
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            a, b = max(a, t0), min(b, t1)
            if b > a:
                dev.append((a, b))
                ops[e.get("name", "?")] += b - a
        elif cat in ("cuda_runtime", "cuda_driver"):
            if t0 <= a <= t1 and any(w in e.get("name", "") for w in LAUNCH_WORDS):
                launches += 1
        elif cat in HOST_CATS and e.get("name") != mark:
            host.append((a, b, e.get("name", "?")))
    busy = union(dev)
    gaps, edge = [], t0
    for a, b in busy + [(t1, t1)]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    by_host = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) / 2
        inside = [h for h in host if h[0] <= mid <= h[1]]
        name = min(inside, key=lambda h: h[1] - h[0])[2] if inside else "(no host op)"
        by_host[name] += b - a
    top = lambda d: [[k, v / 1e6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"window_s": (t1 - t0) / 1e6, "busy_s": sum(b - a for a, b in busy) / 1e6,
            "device_ops": top(ops), "idle_gaps": top(by_host), "launches": launches}


class Slice:
    """``with Slice(device) as s: ...``; then ``s.summary``."""

    def __init__(self, device):
        self.device = device
        self.summary = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        self._sync()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.mark = record_function(MARK)
        self.mark.__enter__()
        return self

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __exit__(self, *exc):
        self._sync()
        self.mark.__exit__(*exc)
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.remove(path)
        events = data.get("traceEvents", []) if isinstance(data, dict) else data
        self.summary = summarize(events)
        return False
