"""K1's (or a library attention kernel's) least time at the cell's
attention shapes over its device time, in % (counts/kernels.py)."""

from benchmark.metrics._common import roofline_pct


def read(summary, work):
    return roofline_pct(summary, work, "attention", ("K1 attention",))
