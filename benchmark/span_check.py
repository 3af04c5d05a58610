"""Checks, on one card, what the span metrics (metrics/_spans.py) rest on,
and what recording spans costs:

    python3 -m benchmark.span_check [--seed N] [--windows 3] [--cells a,b]

  1. One clock: a program span around torch.cuda._sleep and a
     synchronize, traced CUDA-only as trace.Window traces, holds the sleep
     kernel's device record, and by how much on each side (--clock_reps
     times).
  2. Hidden reads: one traced unit (a step, a batch) of each cell under
     torch.cuda.set_sync_debug_mode("warn"): every synchronizing CUDA call
     with the port's source line that made it and the innermost span open
     then, beside the program's own `syncs` count of the same unit.
  3. The cost of recording: the cell's traced window (its mix's
     trace_steps or trace_batches) run in turns with the recorder on and
     forced off (the profiler running in both), --windows times each;
     the unit time of each, and the split of the first window's idle time
     by span with the sum rule (the assigned idle against window_s -
     busy_s).

Prints JSON lines and writes them to chiprun_out/span_check.json.  Needs
a card.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import traceback
import types
import warnings
from contextlib import contextmanager
from pathlib import Path
from unittest import mock

import torch

from .loops import infer_closed, train_closed
from .metrics import _spans
from .run import ROOT, Cell, load_json, reader
from .trace import Window

OUT = ROOT / "chiprun_out" / "span_check.json"
CELLS = ("v3_train_b4_fp32", "v3_train_b4_bf16", "v3_infer_b32_bf16")


def emit(lines, **row):
    lines.append(row)
    print(json.dumps(row, default=float), flush=True)


def clock_check(reps: int, cpu: bool) -> dict:
    """`reps` spans `clock`, each around torch.cuda._sleep and a span
    `sync.clock` that reads a device scalar (a device-to-host copy which
    waits for the sleep), in one profile (CUDA activity as trace.Window
    has it; `cpu`: CPU activity too), after a warm-up launch.  Of each
    rep, in microseconds: lead (the sleep kernel's start - the span's
    start) and trail (the span's end - the kernel's end), as the trace
    has them (`raw`) and after metrics/_spans.py has moved the device's
    times onto the host's clock (`aligned`); and how far the launch
    call's host record starts after the host's clock read just before it
    (`launch_after_read_us`: the profiler's host records and
    time.time_ns() on one clock)."""
    from torch.profiler import ProfilerActivity, profile
    from cfen_vit_tpu_torch.utils.profiling import annotate, spans
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    flag = torch.zeros((), device="cuda")
    reads = []
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(reps):
            with annotate("clock"):
                reads.append(time.time_ns())
                torch.cuda._sleep(2_000_000)      # about 1 ms
                with annotate("sync.clock"):
                    float(flag)
    events = list(prof.profiler.kineto_results.events())
    cuda = torch.autograd.DeviceType.CUDA
    ops = [(e.name(), e.start_ns() / 1e3, e.duration_ns() / 1e3)
           for e in events if e.device_type() == cuda
           and not e.is_user_annotation()]
    kernels = sorted((s, s + d) for n, s, d in ops if "spin_kernel" in n)[1:]
    launches = sorted(e.start_ns() for e in events if e.device_type() != cuda
                      and e.name() == "cudaLaunchKernel")
    recs = spans()
    clock = [(s[4], s[5]) for s in recs if s[0] == "clock"]
    tid = threading.get_ident()
    move = _spans.host_clock({"ops": ops}, recs, tid)
    out = {"activities": "CUDA+CPU" if cpu else "CUDA",
           "kernel_us": [e - s for s, e in kernels]}
    for key, f in (("raw", lambda t: t), ("aligned", move)):
        out[f"lead_us_{key}"] = [(f(k[0] * 1e3) - t[0]) / 1e3
                                 for k, t in zip(kernels, clock)]
        out[f"trail_us_{key}"] = [(t[1] - f(k[1] * 1e3)) / 1e3
                                  for k, t in zip(kernels, clock)]
    out["launch_after_read_us"] = [
        (min(l for l in launches if l >= r) - r) / 1e3 for r in reads]
    out["aligned_inside_50us"] = all(
        0 <= v <= 50 for v in out["lead_us_aligned"] + out["trail_us_aligned"])
    return out


def _port_frame(stack) -> str:
    """The innermost frame of the port, else of the benchmark."""
    def under(package):
        return [f for f in stack if f"{os.sep}{package}{os.sep}" in f.filename]
    f = (under("cfen_vit_tpu_torch") or under("benchmark") or stack)[-1]
    return f"{Path(f.filename).name}:{f.lineno} {f.name}"


def _open_span() -> str:
    from cfen_vit_tpu_torch.utils.profiling import spans
    tid = threading.get_ident()
    open_ = [s[0] for s in spans() if s[3] == tid and s[5] == 0
             and s[0] != "gc"]
    return open_[-1] if open_ else "(no span)"


@contextmanager
def synchronizing_calls(found: dict):
    """Collects {(source line, open span): count} of the warnings of
    torch.cuda.set_sync_debug_mode("warn") inside the block."""
    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return
        key = f"{_port_frame(traceback.extract_stack()[:-1])} [{_open_span()}]"
        found[key] = found.get(key, 0) + 1
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")


@contextmanager
def recording(on: bool):
    """The recorder as it is, or forced off while the profiler runs."""
    from cfen_vit_tpu_torch.utils import profiling as P
    if on:
        yield
        return
    with mock.patch.object(P, "_autograd_profiler",
                           types.SimpleNamespace(_is_profiler_enabled=False)):
        yield


def _unit_fn(cell: Cell, seed: int, device):
    """(a function running one unit, the window's unit count, the count
    of warm-up units)."""
    config, mix = cell.config, cell.mix
    if mix["loop"] == "train_closed":
        trainer, pool, _ = train_closed.setup_program(config, mix, seed,
                                                      device)
        i = [0]

        def unit():
            trainer.set_input(pool[i[0] % len(pool)])
            trainer.optimize_parameters()
            i[0] += 1
        return unit, mix["trace_steps"], mix["checked_steps"]
    model, _, pool = infer_closed.setup_program(config, mix, seed, device)
    b = mix["batch"]
    batches = [pool[k * b:(k + 1) * b] for k in range(len(pool) // b)]
    paths = [f"hazy_{k:03d}.png" for k in range(b)]
    i = [0]

    def unit():
        model.set_input({"B": batches[i[0] % len(batches)], "B_paths": paths})
        model.test()
        i[0] += 1
    return unit, mix["trace_batches"], mix["warm_batches"]


def window(unit, n):
    with Window(n) as w:
        for _ in range(n):
            unit()
    return w.summary


def check_cell(cell: Cell, seed: int, windows: int, lines: list,
               device) -> None:
    from cfen_vit_tpu_torch.utils.profiling import counters, spans
    name = cell.name
    unit, n, warm = _unit_fn(cell, seed, device)
    for _ in range(warm):
        unit()
    torch.cuda.synchronize()

    found = {}
    with synchronizing_calls(found):
        s = window(unit, 1)
    emit(lines, check="hidden_reads", cell=name, syncs_counted=counters().get(
        "syncs", 0), synchronizing_calls=dict(sorted(found.items(),
                                                     key=lambda kv: -kv[1])),
         window_s=s["window_s"])

    times = {True: [], False: []}
    first = None
    for k in range(windows):
        for on in ((True, False) if k % 2 == 0 else (False, True)):
            with recording(on):
                s = window(unit, n)
            times[on].append(1e3 * s["window_s"] / n)
            if on and first is None:
                first = (s, spans(), counters())
    s, recs, counted = first
    split, idle_ns = _spans.idle_by_span(s, recs)
    by_name = {}
    for i, ns in split.items():
        key = recs[i][0] if i is not None else "(no span)"
        by_name[key] = by_name.get(key, 0.0) + ns / 1e6 / s["count"]
    metrics = {}
    with mock.patch.object(_spans, "program", lambda: (recs, counted)):
        for m in cell.per_layer:
            if not m["source"].startswith("program_"):
                continue
            v = reader(m["name"])(s, None)
            if v is not None:
                metrics[m["name"]] = v
    expect = 1e3 * (s["window_s"] - s["busy_s"])
    emit(lines, check="cost_and_split", cell=name, unit_ms_on=times[True],
         unit_ms_off=times[False],
         median_on=statistics.median(times[True]),
         median_off=statistics.median(times[False]),
         spans_a_unit=sum(1 for r in recs if r[0] != "gc") / s["count"],
         collections=sum(1 for r in recs if r[0] == "gc"),
         idle_ms_a_unit_by_span=dict(sorted(by_name.items(),
                                            key=lambda kv: -kv[1])),
         idle_assigned_ms=sum(split.values()) / 1e6,
         window_less_busy_ms=expect,
         sum_rule_gap=abs(sum(split.values()) / 1e6 - expect) / expect,
         busy_s=s["busy_s"], window_s=s["window_s"], metrics=metrics)
    del unit
    gc.collect()
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=2_700_000_011)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--clock_reps", type=int, default=20)
    ap.add_argument("--cells", default=",".join(CELLS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("span_check needs a CUDA device", file=sys.stderr)
        return 2
    lines = []
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    emit(lines, check="env", card=card, torch=torch.__version__,
         cuda=torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for cpu in (False, True):
        emit(lines, check="clock", **clock_check(args.clock_reps, cpu))
    manifest = load_json(ROOT / "BENCHMARK.json")
    for name in filter(None, args.cells.split(",")):
        t0 = time.perf_counter()
        check_cell(Cell(name, manifest), args.seed, args.windows, lines,
                   torch.device("cuda", 0))
        print(f"span_check: {name} in {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text("".join(json.dumps(r, default=float) + "\n" for r in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
