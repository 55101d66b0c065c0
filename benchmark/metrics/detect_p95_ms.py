"""The 95th percentile of every call of the window, each timed on the host
clock from handing the frame to ``Detector.__call__`` until its numpy
outputs are back, in milliseconds."""

from benchmark.metrics.common import percentile


def read(rec):
    return 1e3 * percentile(rec["latencies_s"], 95) if rec["kind"] == "detect" else None
