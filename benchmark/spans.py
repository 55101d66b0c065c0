"""The traced slice read by the program's own spans and counters
(``rtm3d_tpu_torch/utils/profiling.py``: ``span``, ``count``).

``by_span(events)`` reduces the Chrome-trace events of a ``Slice``
(``benchmark/trace.py``), on the same clock and with the same clipping
and union as ``summarize``:

- ``roots``: the root spans (``ROOTS``) that began inside the mark, by
  name: the calls or steps, the divisor of every per-call reading;
- ``device_s``: each kernel, copy and fill inside the mark, put down to
  the innermost program span that held its launch (the CUDA API call of
  the same ``args.correlation``) on any thread: the backward's
  kernels are launched from autograd's thread while the main thread is
  inside ``train.backward``;
- ``idle_s``: each idle gap of the device inside the mark, put down to
  the innermost program span that held its middle.

A program span is a ``record_function`` whose name starts with one of
``PREFIXES``; time outside every one is under ``OUTSIDE``, and a root's
own name holds what ran inside it but outside every layer span. A
program without spans gives no roots.

``program_counters()`` is the seam to the program's counters, None for a
program without them.
"""

from bisect import bisect_right
from collections import Counter, defaultdict

from benchmark.trace import DEVICE_CATS, MARK, union

ROOTS = ("detect.call", "train.step")
PREFIXES = ("detect.", "train.", "net.")
OUTSIDE = "(no span)"


def _innermost(spans: list):
    """``at(t)``: the name of the shortest of ``spans`` ((start, end, name),
    half open) that holds ``t``, else ``OUTSIDE``."""
    edges = sorted({t for a, b, _ in spans for t in (a, b)})
    opens, closes = defaultdict(list), defaultdict(list)
    for i, (a, b, _) in enumerate(spans):
        opens[a].append(i)
        closes[b].append(i)
    active, names = set(), []
    for t in edges:
        active.difference_update(closes[t])
        active.update(opens[t])
        names.append(spans[min(active, key=lambda i: spans[i][1] - spans[i][0])][2] if active else OUTSIDE)

    def at(t: float) -> str:
        k = bisect_right(edges, t) - 1
        return names[k] if k >= 0 else OUTSIDE

    return at


def by_span(events: list, mark: str = MARK) -> dict:
    """``{"roots", "device_s", "idle_s"}`` of the slice's ``events``."""
    marks = [e for e in events if e.get("ph") == "X" and e.get("name") == mark and e.get("cat") == "user_annotation"]
    if not marks:
        raise ValueError(f"the trace holds no {mark!r} mark")
    t0 = float(marks[0]["ts"])
    t1 = t0 + float(marks[0]["dur"])
    spans, launched, dev, roots = [], {}, [], Counter()
    for e in events:
        if e.get("ph") != "X":
            continue
        a = float(e.get("ts", 0.0))
        b = a + float(e.get("dur", 0.0))
        cat, name, corr = e.get("cat"), e.get("name", ""), (e.get("args") or {}).get("correlation")
        if cat == "user_annotation" and name.startswith(PREFIXES) and b > a:
            spans.append((a, b, name))
            if name in ROOTS and t0 <= a <= t1:
                roots[name] += 1
        elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
            launched.setdefault(corr, a)
        elif cat in DEVICE_CATS:
            a, b = max(a, t0), min(b, t1)
            if b > a:
                dev.append((a, b, corr))
    at = _innermost(spans)
    device, idle = defaultdict(float), defaultdict(float)
    for a, b, corr in dev:
        device[at(launched[corr]) if corr in launched else OUTSIDE] += (b - a) / 1e6
    edge = t0
    for a, b in union([(a, b) for a, b, _ in dev]) + [(t1, t1)]:
        if a > edge:
            idle[at((edge + a) / 2)] += (a - edge) / 1e6
        edge = max(edge, b)
    return {"roots": dict(roots), "device_s": dict(device), "idle_s": dict(idle)}


def program_counters():
    """A copy of the program's ``counters``; None where it has none."""
    try:
        from rtm3d_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    return dict(counters)


def per_call(rec: dict, counter: str):
    """``counter``'s count over the traced slice's calls (or steps). The
    program's counters move only while a profiler records, and the slice
    is a run's one profiled stretch, so their values are the slice's."""
    t, counts = rec.get("trace"), program_counters()
    if not t or not t.get("calls") or counts is None:
        return None
    return counts.get(counter, 0) / t["calls"]
