"""The program's ``host_syncs`` counter over the traced slice's steps: the
points where the host waits for the device (the target build's copy of
the corner signs to the device, the input stage reading the ``photo``
seeds back with ``.tolist()``)."""

from benchmark.spans import per_call


def read(rec):
    return per_call(rec, "host_syncs")
