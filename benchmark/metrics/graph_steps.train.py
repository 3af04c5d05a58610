"""Steps replayed from the trainer's captured CUDA graph a step (its
`graph_replays` counter) over the traced window: 1.0 where every step
replays it; nothing for a program that has no such counter."""

from benchmark.metrics._spans import counter_per_unit


def read(summary, work):
    return counter_per_unit(summary, "graph_replays")
