"""The traced window: torch.profiler with CUDA activity only (the host's
ops left out: recording them nearly doubles a bf16 training step and
tabulating them takes tens of seconds) over a fixed count of timed
units, reduced in memory to what the per-layer readers need.

The summary:
  window_s   host seconds from the synchronised start of the first unit
             to the synchronised end of the last;
  count      units (batches or steps) in the window;
  ops        [(name, start_us, dur_us)] of every device record: kernels,
             memcpys and memsets, in start order;
  busy_s     the union of their intervals (overlapping records count
             once), so idle is 1 - busy_s / window_s.
"""

from __future__ import annotations

import re
import time

import torch

# kernel name -> group, first match wins: a copy of the port's
# utils/profiling.py GROUPS, with library attention kernels (flash,
# fmha, memory-efficient) in the attention group
GROUPS = (
    ("K5 mrf forward", r"mrf_fwd_kernel"),
    ("K5 mrf do", r"mrf_bwd_kernel<.*true>"),
    ("K5 mrf dt", r"mrf_bwd_kernel<.*false>"),
    ("K1 attention", r"attn_(wide_)?kernel|flash|fmha|efficient_attention"),
    ("K3 tail", r"tail_(mma|ffma)_kernel"),
    ("K4 stem", r"stem_kernel"),
    ("convolution (cuDNN)", r"conv|cudnn|implicit|wgrad|dgrad|fprop|xmma|"
                            r"winograd|im2col|nchw|nhwc"),
    ("GEMM (cuBLAS)", r"gemm|sm90_|cutlass|cublas|splitK"),
    ("reduction", r"reduce|Reduce|sum|norm"),
    ("copy / cat / index", r"copy|Copy|cat|Cat|index|Index|scatter|gather|"
                           r"transpose|permute"),
    ("elementwise", r"elementwise|vectorized|unrolled|Elementwise"),
)
_COMPILED = tuple((g, re.compile(p)) for g, p in GROUPS)


def group_of(name: str) -> str:
    if is_transfer(name):
        return "memcpy / memset"
    for group, pattern in _COMPILED:
        if pattern.search(name):
            return group
    return "other"


def is_transfer(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def _device_records(prof):
    """(name, start_us, dur_us) of the device's records in a finished
    profile."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != cuda:
            continue
        name = ev.name()
        if (ev.is_user_annotation() or name.startswith("ProfilerStep")
                or "#" in name):
            continue
        out.append((name, ev.start_ns() / 1e3, ev.duration_ns() / 1e3))
    out.sort(key=lambda r: r[1])
    return out


def union_s(ops) -> float:
    busy, end = 0.0, None
    for _, start, dur in ops:
        stop = start + dur
        if end is None or start >= end:
            busy += dur
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    return busy / 1e6


class Window:
    """`with Window(count) as w: ...` traces the block; `w.summary` after."""

    def __init__(self, count: int):
        self.count = count
        self.summary = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            ops = _device_records(self._prof)
            self.summary = {"window_s": window_s, "count": self.count,
                            "ops": ops, "busy_s": union_s(ops)}
        self._prof = None
        return False


def group_s(summary, group: str) -> float:
    return sum(d for n, _, d in summary["ops"] if group_of(n) == group) / 1e6


def breakdown(summary, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps, named by the operation before them and the one after."""
    by_name = {}
    for name, _, dur in summary["ops"]:
        by_name[name] = by_name.get(name, 0.0) + dur / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps, end, prev = [], None, None
    for name, start, dur in summary["ops"]:
        if end is not None and start > end:
            gaps.append((f"after {prev[:80]} before {name[:80]}",
                         (start - end) / 1e6))
        if end is None or start + dur > end:
            end, prev = start + dur, name
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps[:top]]}
