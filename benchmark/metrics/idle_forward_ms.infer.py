"""Device-idle ms a batch assigned to `infer.forward`, the launch of the
generator's forward (metrics/_spans.py): the host enqueueing slower
than the card runs."""

from benchmark.metrics._spans import idle_ms_per_unit


def read(summary, work):
    return idle_ms_per_unit(summary, "infer.forward")
