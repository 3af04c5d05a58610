"""Spans, counters and traces (counterpart of cfen_vit_tpu/utils/profiling.py).

  * `annotate(name, unit=None)` is a span: `with annotate("train.step"):`.
    With no torch profiler running it costs one flag check
    (`torch.autograd.profiler._is_profiler_enabled`): it reads no clock,
    allocates nothing and records nothing.  While any torch profiler
    runs, a CUDA-only one included, it appends one record
        (name, parent_index, unit_id, thread_id, t0_ns, t1_ns)
    to an in-memory list.  Times are `time.time_ns()`, the profiler's own
    clock, so spans and the trace's device records share one time base;
    the parent is the innermost span open on the same thread (-1: none);
    `unit` is the step or batch the span belongs to (the trainer's and
    the inference wrapper's count of batches taken), the parent's when
    not given (-1: none); t1_ns is 0 while the span is open.  Inside
    `start_trace` a span also enters torch.profiler's record_function, so
    the Chrome trace shows it.
  * `count(name, n=1)` adds to a counter while recording is on.
  * `spans()` and `counters()` read what was recorded since recording
    last turned on: a session starts at the first span, count or
    collection recorded while a profiler runs, and ends when another
    profiler starts (the recorder's first session wraps torch's
    `_run_on_profiler_start` to hear of it) or at `start_trace`.  A
    session keeps at most CAPACITY records; later ones are dropped and
    counted (`counters()["spans_dropped"]`).
  * While recording is on, a `gc.callbacks` hook records each garbage
    collection as a span `gc`.
  * `start_trace(logdir)` / `stop_trace()` (and the `trace(logdir)`
    context) run torch.profiler over the steps between them, CPU and, on
    a card, CUDA activity.  `stop_trace` writes into `logdir`:
      trace.json          the Chrome trace (chrome://tracing, Perfetto);
      key_averages.txt    torch's key-averages table by device time;
      summary.json        the window's wall time, its kernel time by
                          group (`GROUPS`), the launches, the device's busy
                          share (the union of its records' intervals over
                          the window: overlapping kernels count once) and
                          `idle_ms_by_span`, the device's idle ms by the
                          innermost span open on the tracing thread ("":
                          none);
    and returns the summary.  The train CLI traces steps 10-15 with
    `--trace_dir`, as the JAX train.py does, each step a span
    `train step <n>`.

The spans and the counter the program records (PERF.md section 3 names
the benchmark metric that reads each):

  train/trainer.py GanTrainer
    train.set_input             set_input
      train.set_input.wire      _u8_wire: the host's check of a float array
      train.set_input.copy      an array's pageable host-to-device copy
    train.step                  optimize_parameters
      train.g_refresh           the bf16 compute copy of G from its masters
      train.g_loss              the G loss
        train.g_forward         the generator's forward
        train.d_on_fake         a D on its branch's fake
        train.vgg               a branch's perceptual loss; ID-MRF and
                                the semantic term
        train.ssim              a branch's SSIM
      train.g_backward          G's backward
      train.d_step              the D loss and its backward
      train.allreduce           the mean over ranks (--mesh_shape only)
      train.graph_replay        a replay of the captured step, in place
                                of the spans from g_refresh to d_step
      sync.skip_gate            the skip gate's read of the G loss
      train.pool                the image pools
      train.adam                Adam on G and the Ds
      train.zero_grad           the grads' reset
    sync.losses                 get_current_losses
    sync.visuals                get_current_visuals
  models/dehazing_model.py DehazingModel
    infer.set_input             set_input
    infer.test                  test
      infer.forward             the forward's launch
      sync.to_host              an output's device-to-host read
  any thread
    gc                          a garbage collection
  counter syncs                 the program's own device-to-host reads,
                                each counted inside its sync.* span
  counter graph_captures        the trainer's captures of its step
  counter graph_replays         the trainer's replays of its step
"""

from __future__ import annotations

import bisect
import contextlib
import gc
import json
import os
import re
import threading
import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

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
CAPACITY = 1 << 18          # records a session keeps


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


# --------------------------------------------------------------------------
# spans and counters
# --------------------------------------------------------------------------

class Recorder:
    """The spans and counters of one recording session (the module's
    `RECORDER`; `annotate`, `count`, `spans` and `counters` use it)."""

    def __init__(self):
        self.capacity = CAPACITY
        self.live = False          # a session is open
        self.trace_names = False   # spans also enter record_function
        self.session = 0
        self._lock = threading.Lock()
        self._records: List[list] = []
        self._counters: Dict[str, int] = {}
        self._stacks: Dict[int, List[int]] = {}   # thread -> open spans
        self._gc_open: Dict[int, tuple] = {}
        self._hooked = False

    def begin(self) -> None:
        """Starts a session: what was recorded before is dropped."""
        with self._lock:
            self.session += 1
            self._records, self._counters = [], {}
            self._stacks, self._gc_open = {}, {}
            self.live = True
        if not self._hooked:
            gc.callbacks.append(_gc_hook)
            _end_sessions_at_profiler_starts()
            self._hooked = True

    def open(self, name: str, unit: Optional[int]) -> int:
        """Records a span's start; its index, or -1 if it was dropped."""
        if not self.live:
            self.begin()
        tid = threading.get_ident()
        stack = self._stacks.get(tid)
        if stack is None:
            stack = self._stacks[tid] = []
        parent = stack[-1] if stack else -1
        if unit is None:
            unit = self._records[parent][2] if parent >= 0 else -1
        rec = [name, parent, unit, tid, time.time_ns(), 0]
        with self._lock:    # no allocation a collection could start from
            if len(self._records) >= self.capacity:
                self._counters["spans_dropped"] = (
                    self._counters.get("spans_dropped", 0) + 1)
                return -1
            self._records.append(rec)
            i = len(self._records) - 1
        stack.append(i)
        return i

    def close(self, i: int, session: int) -> None:
        t1 = time.time_ns()
        if i < 0 or session != self.session:
            return
        rec = self._records[i]
        rec[5] = t1
        stack = self._stacks[rec[3]]
        if stack and stack[-1] == i:
            stack.pop()
        elif i in stack:
            stack.remove(i)

    def add(self, name: str, n: int) -> None:
        if not self.live:
            self.begin()
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def collection(self, phase: str) -> None:
        tid = threading.get_ident()
        if phase == "start":
            self._gc_open[tid] = (self.open("gc", None), self.session)
        elif tid in self._gc_open:
            self.close(*self._gc_open.pop(tid))

    def spans(self) -> List[tuple]:
        with self._lock:
            return [tuple(r) for r in self._records]

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)


RECORDER = Recorder()
_OFF = contextlib.nullcontext()
_ANNOTATED: set = set()      # the names record_function was given


class _Span:
    __slots__ = ("name", "unit", "index", "session", "rf")

    def __init__(self, name: str, unit: Optional[int]):
        self.name, self.unit = name, unit

    def __enter__(self):
        self.index = RECORDER.open(self.name, self.unit)
        self.session = RECORDER.session
        self.rf = None
        if RECORDER.trace_names:
            _ANNOTATED.add(self.name)
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        RECORDER.close(self.index, self.session)
        return False


def annotate(name: str, unit: Optional[int] = None):
    """A span named `name` (module docstring)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, unit)


def count(name: str, n: int = 1) -> None:
    """Adds n to the counter `name` while recording is on."""
    if _autograd_profiler._is_profiler_enabled:
        RECORDER.add(name, n)


def _end_sessions_at_profiler_starts() -> None:
    """Every torch profiler calls torch.autograd.profiler's
    `_run_on_profiler_start` as it starts (where that function exists):
    wrapped, it ends the recorder's session, so the next record starts
    a new one."""
    start = getattr(_autograd_profiler, "_run_on_profiler_start", None)
    if start is None:
        return

    def run_on_profiler_start():
        RECORDER.live = False
        start()
    _autograd_profiler._run_on_profiler_start = run_on_profiler_start


def _gc_hook(phase: str, info: dict) -> None:
    if not _autograd_profiler._is_profiler_enabled:
        return
    RECORDER.collection(phase)


def spans() -> List[tuple]:
    """The session's records (module docstring), in the order they were
    opened."""
    return RECORDER.spans()


def counters() -> Dict[str, int]:
    return RECORDER.counters()


# --------------------------------------------------------------------------
# device time of a finished profile
# --------------------------------------------------------------------------

def device_intervals(prof) -> List[tuple]:
    """(start_ns, end_ns) of every device record of a finished
    torch.profiler run (kernels, memcpys, memsets; not spans) on the
    host's clock, sorted.  The device's timestamps drift from the host's
    by up to several ms over seconds on the H100, so they are moved onto
    it: each device-to-host copy ends as the host call that waited for it
    (its cudaMemcpy*, by correlation id) returns, and a device time moves
    by the offset of these anchors, linear between them and held beyond
    the first and the last."""
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    returns = {ev.correlation_id(): ev.start_ns() + ev.duration_ns()
               for ev in events if ev.device_type() != cuda
               and ev.name().startswith("cudaMemcpy")}
    out, anchors = [], []
    for ev in events:
        name = ev.name()
        if (ev.device_type() != cuda or ev.is_user_annotation()
                or name.startswith("ProfilerStep") or "#" in name):
            continue
        start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
        out.append((start, end))
        if name.startswith("Memcpy DtoH") and ev.correlation_id() in returns:
            anchors.append((end, returns[ev.correlation_id()] - end))
    anchors.sort()
    at = [a for a, _ in anchors]

    def move(t):
        if not anchors:
            return t
        i = bisect.bisect(at, t)
        if i == 0 or i == len(at):
            return t + anchors[min(i, len(at) - 1)][1]
        (t0, o0), (t1, o1) = anchors[i - 1], anchors[i]
        return t + o0 + (o1 - o0) * (t - t0) // max(t1 - t0, 1)
    return sorted((move(s), move(e)) for s, e in out)


def _busy(intervals, t0: int, t1: int) -> List[tuple]:
    """The union of `intervals` (sorted by start) inside [t0, t1]."""
    out: List[list] = []
    for s, e in intervals:
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(b) for b in out]


def busy_ns(intervals, t0: int, t1: int) -> int:
    return sum(e - s for s, e in _busy(intervals, t0, t1))


def idle_ms_by_span(records, intervals, t0: int, t1: int,
                    tid: int) -> Dict[str, float]:
    """The device's idle ms in [t0, t1] (ns) by the name of the innermost
    span of `records` open on thread `tid` at each idle instant ("": no
    span).  The values sum to the window less the union of
    `intervals`."""
    idle, at = [], t0
    for s, e in _busy(intervals, t0, t1):
        if s > at:
            idle.append((at, s))
        at = e
    if at < t1:
        idle.append((at, t1))
    # the innermost open span between consecutive span boundaries
    marks = []
    for i, r in enumerate(records):
        if r[3] == tid:
            marks += [(r[4], 1, i), (r[5] or t1, 0, i)]
    marks.sort()
    segments, stack, prev = [], [], t0
    for t, opening, i in marks:
        if t > prev:
            segments.append((prev, t, records[stack[-1]][0] if stack else ""))
            prev = t
        if opening:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
    segments.append((prev, t1, ""))
    out: Dict[str, float] = {}
    k = 0
    for s, e in idle:
        while k < len(segments) and segments[k][1] <= s:
            k += 1
        j = k
        while j < len(segments) and segments[j][0] < e:
            a, b = max(s, segments[j][0]), min(e, segments[j][1])
            if b > a:
                name = segments[j][2]
                out[name] = out.get(name, 0.0) + (b - a) / 1e6
            j += 1
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


# --------------------------------------------------------------------------
# --trace_dir
# --------------------------------------------------------------------------

_ACTIVE: dict = {}


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def start_trace(logdir: str) -> None:
    """Starts the profiler (one trace at a time) and a span session whose
    spans the Chrome trace shows."""
    from torch.profiler import ProfilerActivity, profile
    if _ACTIVE:
        raise RuntimeError("a trace is already running")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    _sync()
    prof = profile(activities=activities)
    prof.__enter__()
    RECORDER.begin()
    RECORDER.trace_names = True
    _ACTIVE.update(prof=prof, logdir=logdir, t0=time.perf_counter(),
                   t0_ns=time.time_ns(), tid=threading.get_ident())


def tracing() -> bool:
    return bool(_ACTIVE)


def stop_trace() -> dict:
    """Stops the running trace, writes its files into its logdir and
    returns the summary."""
    _sync()
    wall_ms = (time.perf_counter() - _ACTIVE["t0"]) * 1e3
    t0_ns, t1_ns = _ACTIVE["t0_ns"], time.time_ns()
    prof, logdir, tid = _ACTIVE["prof"], _ACTIVE["logdir"], _ACTIVE["tid"]
    _ACTIVE.clear()
    RECORDER.trace_names = False
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
    device = device_intervals(prof)
    summary = {"wall_ms": wall_ms, **split,
               "busy_share": busy_ns(device, t0_ns, t1_ns)
               / max(t1_ns - t0_ns, 1),
               "idle_ms_by_span": idle_ms_by_span(spans(), device, t0_ns,
                                                  t1_ns, tid),
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
