"""The network's counted work per image, times the images the slice
completed, over the slice's seconds and the bf16 tensor-core peak, in
percent: the whole call's (or step's) share of the chip's peak."""

from benchmark.metrics.common import work_share


def read(rec):
    return work_share(rec, "window_s")
