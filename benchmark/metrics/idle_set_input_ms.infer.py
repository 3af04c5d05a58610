"""Device-idle ms a batch assigned to the inference wrapper's
`infer.set_input` span (models/dehazing_model.py, the uint8 wire;
metrics/_spans.py)."""

from benchmark.metrics._spans import idle_ms_per_unit


def read(summary, work):
    return idle_ms_per_unit(summary, "infer.set_input")
