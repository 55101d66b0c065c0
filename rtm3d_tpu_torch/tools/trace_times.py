"""Device time from ``torch.profiler`` Chrome traces.

Port of ``tools/trace_times.py``: ``summarize`` (:46) and
``module_durations`` (:98), for the traces ``utils/profiling.py::
device_trace`` writes (``trace_<pid>_<n>.json``). A JAX trace has device
lanes of XLA ops and XLA modules; a torch trace has CUDA kernels, copies
and fills (``cat`` ``kernel``, ``gpu_memcpy``, ``gpu_memset``) on one lane
per device stream, and the ``record_function`` marks of the host
(``user_annotation``) with their device spans (``gpu_user_annotation``).
So here:

- each device lane's busy time is the union of its kernels, copies and
  fills;
- the top-N kernels by device time;
- a call is a ``record_function`` mark: each call's duration, on the
  device where the trace has the mark's device span, else on the host
  (``call_durations``, the counterpart of ``module_durations``).

Without device lanes (a trace taken on the CPU) ``summarize(...,
host=True)`` reads the host's ``cpu_op`` events instead: those are host
times, not device times (the CPU tests read a trace so).

    python -m rtm3d_tpu_torch.tools.trace_times LOGDIR_OR_TRACE [--top N]
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def find_trace_file(path: str) -> str:
    """``path`` if it is a file, else the newest ``*.json`` or
    ``*.json.gz`` under it."""
    if os.path.isfile(path):
        return path
    hits = [p for pat in ("*.json", "*.json.gz") for p in glob.glob(os.path.join(path, "**", pat), recursive=True)]
    if not hits:
        raise FileNotFoundError(f"no trace .json(.gz) under {path}")
    return max(hits, key=os.path.getmtime)


def load_events(path: str) -> list:
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        data = json.load(f)
    return data.get("traceEvents", []) if isinstance(data, dict) else data


def _lane_names(events):
    procs, threads = {}, {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            procs[e["pid"]] = e["args"].get("name", "")
        elif e.get("ph") == "M" and e.get("name") == "thread_name":
            threads[(e["pid"], e.get("tid"))] = e["args"].get("name", "")
    return procs, threads


def summarize(path: str, top: int = 25, host: bool = False):
    """``(lane_busy_us, top_ops, span_us, calls)`` of the trace at (or
    newest under) ``path``: the busy microseconds of each device lane
    (``{lane: us}``), the ``top`` kernels by summed device time (``[(name,
    us)]``), the span from the first device event's start to the last's
    end, and each ``record_function`` mark's summed duration (``[(name,
    us)]``, largest first; device spans where the trace has them). With
    ``host`` the host's ``cpu_op`` events stand in for the kernels."""
    events = load_events(find_trace_file(path))
    procs, threads = _lane_names(events)
    cats = ("cpu_op",) if host else DEVICE_CATS
    lanes = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in cats:
            lanes[f"{procs.get(e.get('pid'), e.get('pid'))}/{threads.get((e.get('pid'), e.get('tid')), e.get('tid'))}"].append(
                (float(e.get("ts", 0.0)), float(e.get("dur", 0.0)), e.get("name", "?")))
    lane_busy, op_time = {}, defaultdict(float)
    t_min, t_max = float("inf"), 0.0
    for lane, evs in lanes.items():
        # busy: the union of the lane's intervals (host ops nest, kernels on
        # a stream do not)
        evs.sort()
        busy, end = 0.0, float("-inf")
        for ts, dur, name in evs:
            busy += max(0.0, ts + dur - max(ts, end))
            end = max(end, ts + dur)
            op_time[name] += dur
        lane_busy[lane] = busy
        t_min, t_max = min(t_min, evs[0][0]), max(t_max, end)
    calls = {k: sum(v) for k, v in call_durations(path).items()}
    top_ops = sorted(op_time.items(), key=lambda kv: -kv[1])[:top]
    span = t_max - t_min if t_max > t_min else 0.0
    return dict(lane_busy), top_ops, span, sorted(calls.items(), key=lambda kv: -kv[1])


def call_durations(path: str, device: bool = True) -> dict:
    """Each ``record_function`` mark's durations in microseconds, in
    trace order: ``{name: [us, ...]}``. With ``device`` and where the
    trace has the marks' device spans (``gpu_user_annotation``: from the
    first kernel launched inside the mark to the end of the last), those;
    else the host's spans (``user_annotation``)."""
    events = load_events(find_trace_file(path))
    out = {cat: defaultdict(list) for cat in ("gpu_user_annotation", "user_annotation")}
    for e in sorted((e for e in events if e.get("ph") == "X" and e.get("cat") in out),
                    key=lambda e: float(e.get("ts", 0.0))):
        out[e["cat"]][e.get("name", "?")].append(float(e.get("dur", 0.0)))
    if device and out["gpu_user_annotation"]:
        return dict(out["gpu_user_annotation"])
    return dict(out["user_annotation"])


def main(argv=None):
    p = argparse.ArgumentParser("trace_times")
    p.add_argument("path", help="a trace .json(.gz), or a directory holding one (the newest is read)")
    p.add_argument("--top", type=int, default=25)
    args = p.parse_args(argv)
    lanes, top_ops, span, calls = summarize(args.path, args.top)
    print(f"trace span (device): {span / 1e3:.3f} ms")
    for lane, busy in sorted(lanes.items(), key=lambda kv: -kv[1]):
        print(f"lane {lane}: busy {busy / 1e3:.3f} ms")
    print("\ncalls (record_function marks):")
    for name, t in calls[:10]:
        print(f"  {t / 1e3:9.3f} ms  {name[:110]}")
    print(f"\ntop {args.top} kernels by time:")
    for name, t in top_ops:
        print(f"  {t / 1e3:9.3f} ms  {name[:110]}")
    return lanes, top_ops, span, calls


if __name__ == "__main__":
    main()
