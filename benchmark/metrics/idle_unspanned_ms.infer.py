"""Device-idle ms a batch under no program span (metrics/_spans.py): the
harness's loop, or program code without a span."""

from benchmark.metrics._spans import idle_ms_per_unit


def read(summary, work):
    return idle_ms_per_unit(summary, None)
