"""Kernel launches, copies, fills and graph launches the runtime issued in
the traced slice, per call."""


def read(rec):
    t = rec.get("trace")
    if not t or not t.get("calls") or not t.get("launches"):
        return None
    return t["launches"] / t["calls"]
