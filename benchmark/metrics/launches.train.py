"""Kernel records per step (memcpys and memsets left out)."""

from benchmark.trace import is_transfer


def read(summary, work):
    n = sum(1 for name, _, _ in summary["ops"] if not is_transfer(name))
    return n / summary["count"] if n else None
