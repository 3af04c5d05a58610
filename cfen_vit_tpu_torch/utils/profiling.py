"""Profiling and step timing (counterpart of cfen_vit_tpu/utils/profiling.py).

  * `start_trace(logdir)` / `stop_trace()` (and the `trace(logdir)`
    context) run torch.profiler over the steps between them, CPU and, on
    a card, CUDA activity.  `stop_trace` writes into `logdir`:
      trace.json          the Chrome trace (chrome://tracing, Perfetto);
      key_averages.txt    torch's key-averages table by device time;
      summary.json        the window's wall time, its kernel time by
                          group (`GROUPS`), the launches and the device's
                          busy share (kernel time over wall time);
    and returns the summary.  The train CLI traces steps 10-15 with
    `--trace_dir`, as the JAX train.py does.
  * `annotate(name)` names a span in the trace (torch.profiler's
    record_function); the train CLI names each step `train step <n>`.
  * `StepTimer` keeps the reference's console step times and a rolling
    summary (mean, p50, p95).
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import time
from typing import Dict, List, Optional

import torch

# kernel name -> group, first match wins
GROUPS = (
    ("K5 mrf forward", r"mrf_fwd_kernel"),
    ("K5 mrf do", r"mrf_bwd_kernel<.*true>"),
    ("K5 mrf dt", r"mrf_bwd_kernel<.*false>"),
    ("K1 attention", r"attn_(wide_)?kernel"),
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


def group_of(name: str) -> str:
    for group, pattern in GROUPS:
        if re.search(pattern, name):
            return group
    return "other"


def kernel_split(averages) -> dict:
    """Device time of a finished torch.profiler run (its key_averages()):
    ms by kernel group, the launches, and the top kernels (ms, count,
    name)."""
    groups: Dict[str, float] = {}
    kernels: List[tuple] = []
    launches = 0
    for ev in averages:
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        # a span of `annotate` (or "#": torch's own) shows on the device's
        # timeline too, and is not a kernel
        if (dev_us <= 0 or "#" in ev.key or ev.key in _ANNOTATED
                or getattr(ev, "is_user_annotation", False)
                or ev.device_type != torch.autograd.DeviceType.CUDA):
            continue
        launches += ev.count
        g = group_of(ev.key)
        groups[g] = groups.get(g, 0.0) + dev_us / 1e3
        kernels.append((dev_us / 1e3, ev.count, ev.key[:120]))
    kernels.sort(reverse=True)
    return {"groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
            "kernel_ms": sum(groups.values()), "launches": launches,
            "top": kernels[:25]}


_ACTIVE: dict = {}
_ANNOTATED: set = set()      # the names `annotate` gave


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def start_trace(logdir: str) -> None:
    """Starts the profiler (one trace at a time)."""
    from torch.profiler import ProfilerActivity, profile
    if _ACTIVE:
        raise RuntimeError("a trace is already running")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    _sync()
    prof = profile(activities=activities)
    prof.__enter__()
    _ACTIVE.update(prof=prof, logdir=logdir, t0=time.perf_counter())


def tracing() -> bool:
    return bool(_ACTIVE)


def stop_trace() -> dict:
    """Stops the running trace, writes its files into its logdir and
    returns the summary."""
    _sync()
    wall_ms = (time.perf_counter() - _ACTIVE["t0"]) * 1e3
    prof, logdir = _ACTIVE["prof"], _ACTIVE["logdir"]
    _ACTIVE.clear()
    clock = [time.perf_counter()]

    def lap():
        clock.append(time.perf_counter())
        return (clock[-1] - clock[-2]) * 1e3
    prof.__exit__(None, None, None)
    write = {"stop_ms": lap()}
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    write["export_ms"] = lap()
    averages = prof.key_averages()
    sort = ("self_device_time_total" if torch.cuda.is_available()
            else "self_cpu_time_total")
    with open(os.path.join(logdir, "key_averages.txt"), "w") as fh:
        fh.write(averages.table(sort_by=sort, row_limit=60))
    write["table_ms"] = lap()
    split = kernel_split(averages)
    summary = {"wall_ms": wall_ms, **split,
               "busy_share": split["kernel_ms"] / wall_ms if wall_ms else 0.0,
               "steps": sorted({ev.key for ev in averages
                                if ev.key.startswith("train step ")},
                               key=lambda k: int(k.rsplit(" ", 1)[1])),
               "write_ms": write}
    with open(os.path.join(logdir, "summary.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    return summary


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """A trace of the block when logdir is set; nothing otherwise."""
    if not logdir:
        yield
        return
    start_trace(logdir)
    try:
        yield
    finally:
        stop_trace()


def annotate(name: str):
    _ANNOTATED.add(name)
    return torch.profiler.record_function(name)


class StepTimer:
    def __init__(self, window: int = 200):
        self.window = window
        self.times: List[float] = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return dt

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        ts = sorted(self.times)
        n = len(ts)
        return {"mean_s": sum(ts) / n,
                "p50_s": ts[n // 2],
                "p95_s": ts[min(n - 1, int(n * 0.95))],
                "steps": n}
