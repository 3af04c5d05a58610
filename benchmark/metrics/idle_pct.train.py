"""The share of the traced window in which no kernel, memcpy or memset
ran on the device (the union of their intervals), in %."""

from benchmark.metrics._common import idle_pct


def read(summary, work):
    return idle_pct(summary)
