"""Host ms a step inside the trainer's `train.set_input` span
(train/trainer.py GanTrainer.set_input: the uint8 wire check and the
pageable copies), over the traced window (metrics/_spans.py)."""

from benchmark.metrics._spans import span_ms_per_unit


def read(summary, work):
    return span_ms_per_unit(summary, "train.set_input")
