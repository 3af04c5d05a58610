"""Device-idle ms a step assigned to `train.step` and its children but
the `sync.*` reads and collections (metrics/_spans.py): the host
dispatching slower than the card runs."""

from benchmark.metrics._spans import idle_ms_per_unit


def read(summary, work):
    return idle_ms_per_unit(summary, "train.step")
