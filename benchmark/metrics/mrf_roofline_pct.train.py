"""K5's (forward, do and dt) least time at the ID-MRF's shapes over
their device time, in % (counts/kernels.py)."""

from benchmark.metrics._common import roofline_pct


def read(summary, work):
    return roofline_pct(summary, work, "mrf",
                        ("K5 mrf forward", "K5 mrf do", "K5 mrf dt"))
