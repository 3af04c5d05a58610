"""The program's own device-to-host reads a step (its `syncs` counter,
counted inside the `sync.*` spans) over the traced window."""

from benchmark.metrics._spans import counter_per_unit


def read(summary, work):
    return counter_per_unit(summary, "syncs")
