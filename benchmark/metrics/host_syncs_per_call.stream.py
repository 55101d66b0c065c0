"""The program's ``host_syncs`` counter over the traced slice's calls: the
points where the host waits for the device (each output key's ``.cpu()``;
the copies of host lists to the device: the 3D solve's priors, and the
normalisation's mean and std for uint8 frames)."""

from benchmark.spans import per_call


def read(rec):
    return per_call(rec, "host_syncs")
