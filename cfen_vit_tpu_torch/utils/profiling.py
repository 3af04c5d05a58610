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
      trace.json          the Chrome trace (chrome://tracing, Perfetto),
                          every span beside the device's rows;
      key_averages.txt    torch's key-averages table by device time.
    The train CLI traces steps 10-15 with `--trace_dir`, as the JAX
    train.py does, each step a span `train step <n>`.  The device's idle
    time by span and its time by kernel group are the benchmark's
    reckoning (`python3 -m benchmark.run --trace 1`), which reads the
    recorder.

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
  train/pix2pixhd.py EpdnTrainer (names as above where the work is the
  same)
    train.set_input             set_input (A and B: .wire, .copy)
    train.step                  optimize_parameters
      train.g_loss              the G loss
        train.g_forward         the LocalEnhancer's forward
          train.dehaze          its two Dehaze enhancer blocks
        train.d_on_fake         D on the fake pair, with features
        train.feat_match        D on the real pair, with features, and
                                the feature-matching L1 terms
        train.vgg               the perceptual loss
      train.g_backward          G's backward
      train.pool                the image pool
      train.d_step              the D loss on the pooled pair and the
                                real pair, and its backward
      train.adam                Adam on G and D
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
  counter d_passes              EpdnTrainer's MultiscaleDiscriminator
                                forwards
"""

from __future__ import annotations

import contextlib
import gc
import os
import threading
import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

CAPACITY = 1 << 18          # records a session keeps


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


class _Span:
    __slots__ = ("name", "unit", "index", "session", "rf")

    def __init__(self, name: str, unit: Optional[int]):
        self.name, self.unit = name, unit

    def __enter__(self):
        self.index = RECORDER.open(self.name, self.unit)
        self.session = RECORDER.session
        self.rf = None
        if RECORDER.trace_names:
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
    _ACTIVE.update(prof=prof, logdir=logdir)


def tracing() -> bool:
    return bool(_ACTIVE)


def stop_trace() -> None:
    """Stops the running trace and writes its files into its logdir."""
    _sync()
    prof, logdir = _ACTIVE["prof"], _ACTIVE["logdir"]
    _ACTIVE.clear()
    RECORDER.trace_names = False
    prof.__exit__(None, None, None)
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    sort = ("self_device_time_total" if torch.cuda.is_available()
            else "self_cpu_time_total")
    with open(os.path.join(logdir, "key_averages.txt"), "w") as fh:
        fh.write(prof.key_averages().table(sort_by=sort, row_limit=60))


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
