"""Device-idle ms a step assigned to `train.set_input` and its
children (metrics/_spans.py): the card waiting on the host's batch
check and copies."""

from benchmark.metrics._spans import idle_ms_per_unit


def read(summary, work):
    return idle_ms_per_unit(summary, "train.set_input")
