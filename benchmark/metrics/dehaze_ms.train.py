"""Host ms a step inside EpdnTrainer's `train.dehaze` span: launching
the two Dehaze enhancer blocks of the generator's forward, a pyramid of
20-channel pools, 1x1 convolutions and upsamplings, many small
launches.  Read on the host's clock alone (metrics/_spans.py
`span_ms_per_unit`), which needs no device-to-host copy to anchor it:
the EPDN step reads nothing back.  Nothing for a program without that
span."""

from benchmark.metrics._spans import span_ms_per_unit


def read(summary, work):
    return span_ms_per_unit(summary, "train.dehaze")
