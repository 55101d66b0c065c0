"""One traced run of a cell, split by the program's spans:

    python3 -m benchmark.layers --workload <name> --seed <n> --seconds <s>

from the root of a checkout. Runs the cell as ``benchmark.run`` does with
``--trace 1`` (its result line first), reduces the same slice's trace by
``benchmark/spans.py::by_span`` as well, and prints one more JSON line:
``layers``, with the slice's root spans (``roots``), its ``busy_ms`` and
``window_ms``, the device's milliseconds and idle milliseconds a call
(or step) by span (``device_ms``, ``idle_ms``: a root's own name is what
ran inside it but outside every layer span), and the program's counters
a call (``counters``). With no root span (a program without spans) only
the roots are given; with no device event (a CPU run) no device reading.
"""

import json
import sys

from benchmark import run, spans, trace


def split(parts: dict, summary: dict, counts) -> dict:
    """The per-call split of one slice: ``parts`` from ``by_span``,
    ``summary`` from ``summarize``."""
    calls = sum(parts["roots"].values())
    out = {"roots": parts["roots"]}
    if not calls:
        return out
    out["counters"] = {k: v / calls for k, v in (counts or {}).items()}
    if parts["device_s"]:
        per = lambda d: {k: 1e3 * v / calls for k, v in sorted(d.items(), key=lambda kv: -kv[1])}
        out.update(busy_ms=1e3 * summary["busy_s"] / calls, window_ms=1e3 * summary["window_s"] / calls,
                   device_ms=per(parts["device_s"]), idle_ms=per(parts["idle_s"]))
    return out


def main(argv=None, device=None) -> int:
    """As ``benchmark.run.main``; ``device`` is for the harness's own tests."""
    args = run.parse_args(argv)
    seen = []
    plain = trace.summarize

    def summarize(events, mark=trace.MARK):
        summary = plain(events, mark)
        seen.append((spans.by_span(events, mark), summary))
        return summary

    trace.summarize = summarize
    try:
        rc = run.main(["--workload", args.workload, "--seed", str(args.seed), "--seconds", str(args.seconds),
                       "--trace", "1"], device=device)
    finally:
        trace.summarize = plain
    if rc == 0 and seen:
        print(json.dumps({"layers": split(*seen[-1], spans.program_counters())}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
