"""Helpers the per-layer readers share.  A reader is
`read(summary, work) -> float | None`: `summary` is trace.Window's,
`work` the cell's counted work per unit ({"dtype", "model_flops",
"attention": [(flops, bytes)], "mrf": [(flops, bytes)]}).  A reader
that finds nothing to read returns None, and the metric is left out."""

from benchmark.counts.peaks import PEAK_FLOPS, least_s
from benchmark.trace import group_s


def idle_pct(summary):
    if summary["window_s"] <= 0 or not summary["ops"]:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])


def mfu_pct(summary, work):
    flops = work.get("model_flops")
    if not flops or summary["window_s"] <= 0:
        return None
    return (100.0 * flops * summary["count"] / summary["window_s"]
            / PEAK_FLOPS[work["dtype"]])


def roofline_pct(summary, work, key, groups):
    """The least time of the unit's calls of one kernel (each call by
    itself), over the device time of its groups."""
    spent = sum(group_s(summary, g) for g in groups)
    calls = work.get(key) or []
    if spent <= 0 or not calls:
        return None
    least = summary["count"] * sum(least_s(f, b, work["dtype"]) for f, b in calls)
    return 100.0 * least / spent
