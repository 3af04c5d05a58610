"""Model FLOPs of the steps over the traced window's time, against the
cell dtype's peak (counts/flops.py, counts/peaks.py), in %."""

from benchmark.metrics._common import mfu_pct


def read(summary, work):
    return mfu_pct(summary, work)
