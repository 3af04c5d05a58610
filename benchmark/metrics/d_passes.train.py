"""MultiscaleDiscriminator forwards a step (EpdnTrainer's `d_passes`
counter) over the traced window: D on the fake and the real pair for G,
on the pooled and the real pair for D; nothing for a program without
that counter."""

from benchmark.metrics._spans import counter_per_unit


def read(summary, work):
    return counter_per_unit(summary, "d_passes")
