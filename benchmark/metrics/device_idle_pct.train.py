"""The share of the traced slice in which no kernel, copy or fill ran on
the device (the union of their intervals), in percent."""

from benchmark.metrics.common import idle_pct


def read(rec):
    return idle_pct(rec)
