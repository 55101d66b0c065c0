"""Arithmetic the readers share."""

import math


def percentile(values, q: float) -> float:
    """The ``q``-th percentile by linear interpolation between the order
    statistics (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def idle_pct(rec: dict):
    t = rec.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def work_share(rec: dict, over: str):
    """The slice's counted work at the peak rate, over the device's busy
    time (``over="busy_s"``: the network's roofline share) or over the
    slice (``"window_s"``: MFU), in percent."""
    t = rec.get("trace")
    if not t or not t.get("flops_per_image") or t[over] <= 0:
        return None
    return 100.0 * t["flops_per_image"] * t["images"] / t["peak_flops"] / t[over]
