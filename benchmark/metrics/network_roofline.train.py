"""The network's counted work at the bf16 tensor-core peak (989 TFLOP/s,
the operations bound it) over the device's busy time in the slice, in
percent: the share of their roofline the kernels reach, whatever kernels
run the network."""

from benchmark.metrics.common import work_share


def read(rec):
    return work_share(rec, "busy_s")
