"""The port's spans and counters (cfen_vit_tpu_torch/utils/profiling.py)
and the benchmark's reckoning of device idle time by span
(benchmark/metrics/_spans.py), on the CPU:

  * with no profiler running a span records nothing and reads no clock;
  * under a profiler spans nest with their parents and units, on the
    profiler's clock, counters count and collections are spans;
  * a GanTrainer step and a DehazingModel batch record the span tree the
    module's docstring lists, and `syncs` counts the reads they make;
  * the benchmark's reckoning gives known idle a span on a made-up
    window, and it sums to the window's idle time; the eight readers
    return nothing for a program without the recorder.
"""

import gc
import sys
import tempfile
import threading
import time
import types
from collections import Counter
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark.metrics import _spans as S
from benchmark.run import reader
from cfen_vit_tpu_torch.utils import profiling as P

SPAN_METRICS = ("set_input_ms.train", "idle_set_input_ms.train",
                "idle_step_ms.train", "idle_unspanned_ms.train", "syncs.train",
                "idle_set_input_ms.infer", "idle_forward_ms.infer",
                "idle_unspanned_ms.infer")


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def by_name(records):
    return [r for r in records if r[0] != "gc"]


# --------------------------------------------------------------------------
# the recorder
# --------------------------------------------------------------------------

def test_off_path_records_nothing_and_reads_no_clock():
    P.RECORDER.begin()
    with mock.patch.object(P.time, "time_ns", side_effect=AssertionError), \
            mock.patch.object(torch.profiler, "record_function",
                              side_effect=AssertionError):
        for _ in range(3):
            with P.annotate("train.step", 7):
                P.count("syncs")
        gc.collect()
    assert P.spans() == [] and P.counters() == {}


def test_on_path_nests_on_the_profilers_clock():
    with cpu_profile() as prof:
        with P.annotate("outer", 5):
            with P.annotate("inner"):
                with record_function("marker"):
                    torch.ones(8).sum()
                P.count("syncs", 2)
            P.count("syncs")
        with P.annotate("second", 6):
            pass
    recs = by_name(P.spans())
    assert [r[0] for r in recs] == ["outer", "inner", "second"]
    (_, p0, u0, t0, a0, b0), (_, p1, u1, t1, a1, b1) = recs[:2]
    (_, p2, u2, _, a2, b2), = recs[2:]
    assert (p0, p1, p2) == (-1, 0, -1) and (u0, u1, u2) == (5, 5, 6)
    assert t0 == t1 == threading.get_ident()
    assert a0 <= a1 <= b1 <= b0 <= a2 <= b2
    assert P.counters() == {"syncs": 3}
    marker = [ev for ev in prof.profiler.kineto_results.events()
              if ev.name() == "marker"]
    assert len(marker) == 1
    # the profiler's clock is time.time_ns()'s: the marker opened inside
    # `inner` starts within 1 ms of it and ends inside it
    assert 0 <= marker[0].start_ns() - a1 < 1_000_000
    assert marker[0].start_ns() + marker[0].duration_ns() <= b1 + 1_000_000


def test_sessions_collections_and_capacity():
    with cpu_profile():
        with P.annotate("old"):
            pass
    with P.annotate("off"):         # no profiler: nothing recorded
        pass
    # the session is read after its profiler has stopped
    assert [r[0] for r in by_name(P.spans())] == ["old"]
    capacity = P.RECORDER.capacity
    try:
        with cpu_profile():
            with P.annotate("host", 3):
                gc.collect()
            P.RECORDER.capacity = len(P.spans()) + 1
            for _ in range(3):
                with P.annotate("late"):
                    pass
    finally:
        P.RECORDER.capacity = capacity
    recs = P.spans()
    assert recs[0][0] == "host" and "old" not in [r[0] for r in recs]
    collections = [r for r in recs if r[0] == "gc"]
    assert collections and all(r[1] == 0 and r[2] == 3 and r[5] >= r[4] > 0
                               for r in collections)
    assert [r[0] for r in recs].count("late") == 1
    assert P.counters()["spans_dropped"] == 2


# --------------------------------------------------------------------------
# the trainer's and the inference wrapper's spans
# --------------------------------------------------------------------------

STEP_CHILDREN = {"train.g_loss": 1, "train.g_backward": 1, "train.d_step": 1,
                 "sync.skip_gate": 1, "train.pool": 1, "train.adam": 1,
                 "train.zero_grad": 1}
G_LOSS_CHILDREN = {"train.g_forward": 1, "train.d_on_fake": 3,
                   "train.vgg": 4, "train.ssim": 3}


def test_trainer_step_records_the_span_tree():
    from cfen_vit_tpu_torch.parallel.mesh import tiny_batch, tiny_trainer
    tr = tiny_trainer(2, "", tempfile.mkdtemp())
    with cpu_profile():
        tr.set_input(tiny_batch(2))
        tr.optimize_parameters()
        steps = P.counters()["syncs"]
        losses = tr.get_current_losses()
        after_losses = P.counters()["syncs"]
        visuals = tr.get_current_visuals()
    recs = P.spans()
    names = [r[0] for r in recs]

    def children(parent):
        return Counter(r[0] for r in recs
                       if r[1] >= 0 and names[r[1]] == parent and r[0] != "gc")
    roots = [r[0] for r in by_name(recs) if r[1] < 0]
    assert roots == ["train.set_input", "train.step", "sync.losses",
                     "sync.visuals"]
    assert children("train.set_input") == {"train.set_input.wire": 4,
                                           "train.set_input.copy": 4}
    assert children("train.step") == STEP_CHILDREN     # float32: no refresh
    assert children("train.g_loss") == G_LOSS_CHILDREN
    assert all(r[2] == tr.batches == 1 for r in recs)
    assert all(r[5] >= r[4] > 0 for r in recs)
    # the skip gate's one read, one a loss term, one a visual
    assert steps == 1 and after_losses == 1 + len(losses)
    assert P.counters()["syncs"] == 1 + len(losses) + len(visuals)


def test_inference_batch_records_its_spans():
    from cfen_vit_tpu_torch.config import parse_args
    from cfen_vit_tpu_torch.models.dehazing_model import DehazingModel
    from cfen_vit_tpu_torch.parallel.mesh import TINY
    argv = ["--gpu_ids", "-1", "--sb", "--out_all"]
    for k, v in TINY.items():
        argv += [f"--{k}", str(v)]
    model = DehazingModel(parse_args(argv, is_train=False, save_opt=False),
                          torch.device("cpu"))
    model.net.eval().requires_grad_(False)
    x = np.random.RandomState(3).randint(0, 256, (1, 128, 128, 3), np.uint8)
    model.set_input({"B": x, "B_paths": ["a.png"]})
    model.test()                    # the ActNorms' init pass
    with cpu_profile():
        model.set_input({"B": x, "B_paths": ["a.png"]})
        out = model.test()
    recs = by_name(P.spans())
    assert [(r[0], recs[r[1]][0] if r[1] >= 0 else None) for r in recs] == [
        ("infer.set_input", None), ("infer.test", None),
        ("infer.forward", "infer.test"), ("sync.to_host", "infer.test")]
    assert {r[2] for r in recs} == {2} and list(out) == ["fake_A"]
    assert P.counters() == {"syncs": 1}


# --------------------------------------------------------------------------
# idle time by span
# --------------------------------------------------------------------------

MS = 1_000_000          # ns


def made_up_window():
    """A 100-ms window starting at 1000 ms, two steps: the device runs
    [10, 30), [20, 40) (overlapping: counted once), [60, 70), [95, 100)
    ms; the host's spans on thread 1, a collection inside the first
    step's G loss, a read at the end of the second, and a span of
    another thread across part of the window."""
    t = 1000 * MS
    ops = [("k1", (t + 10 * MS) / 1e3, 20 * 1e3),
           ("k2", (t + 20 * MS) / 1e3, 20 * 1e3),
           ("Memcpy HtoD", (t + 60 * MS) / 1e3, 10 * 1e3),
           ("k3", (t + 95 * MS) / 1e3, 5 * 1e3)]
    summary = {"window_s": 0.1, "count": 2, "ops": ops, "busy_s": 0.045}

    def rec(name, parent, unit, a, b, tid=1):
        return (name, parent, unit, tid, t + a * MS, t + b * MS)
    spans = [rec("train.set_input", -1, 1, 0, 5),           # 0
             rec("train.set_input.copy", 0, 1, 2, 4),       # 1
             rec("train.step", -1, 1, 5, 50),               # 2
             rec("train.g_loss", 2, 1, 5, 45),              # 3
             rec("gc", 3, 1, 41, 44),                       # 4
             rec("train.set_input", -1, 2, 55, 62),         # 5
             rec("train.step", -1, 2, 62, 90),              # 6
             rec("sync.skip_gate", 6, 2, 85, 90),           # 7
             rec("elsewhere", -1, -1, 0, 30, tid=2)]        # 8
    return summary, spans


def test_benchmark_reckoning_assigns_idle_to_the_innermost_span():
    summary, spans = made_up_window()
    split, total = S.idle_by_span(summary, spans)
    got = {(spans[i][0] if i is not None else None, i): ns / MS
           for i, ns in split.items()}
    # idle [0, 10) [40, 60) [70, 95): 55 ms; the innermost span of thread
    # 1 in each stretch
    assert got == pytest.approx({
        ("train.set_input", 0): 2 + 1, ("train.set_input.copy", 1): 2,
        ("train.g_loss", 3): 5 + 1 + 1, ("gc", 4): 3, ("train.step", 2): 5,
        ("train.set_input", 5): 5, ("train.step", 6): 15,
        ("sync.skip_gate", 7): 5, (None, None): 5 + 5})
    # the sum rule: every idle instant once
    assert sum(split.values()) == total == pytest.approx(
        (summary["window_s"] - summary["busy_s"]) * 1e9)


def drifting_window(late_ms):
    """Two steps whose skip gates' reads end as their spans do; the
    device's clock runs late by 0 until the first read, then by up to
    `late_ms` at the second, linearly, and by `late_ms` after it."""
    t = 1000 * MS

    def late(ms):
        return late_ms * min(max(ms - 32, 0), 50) / 50

    def op(name, a, b):
        return (name, (t + (a + late(a)) * MS) / 1e3,
                (b + late(b) - a - late(a)) * 1e3)
    ops = [op("k1", 5, 31.9), op("Memcpy DtoH", 31.9, 32),
           op("k2", 55, 81.9), op("Memcpy DtoH", 81.9, 82), op("k3", 95, 100)]
    summary = {"window_s": 0.1, "count": 2, "ops": ops, "busy_s": 0.0542}

    def rec(name, parent, unit, a, b):
        return (name, parent, unit, 1, t + a * MS, t + b * MS)
    spans = [rec("train.step", -1, 1, 0, 40),
             rec("sync.skip_gate", 0, 1, 30, 32),
             rec("train.step", -1, 2, 50, 90),
             rec("sync.skip_gate", 2, 2, 80, 82)]
    return summary, spans


def test_benchmark_reckoning_moves_a_drifting_device_clock():
    """The reads' ends put the device's records back on the host's clock:
    the split is the one of a device clock that does not drift."""
    want, _ = S.idle_by_span(*drifting_window(0.0))
    got, total = S.idle_by_span(*drifting_window(3.0))
    assert {i: ns / MS for i, ns in got.items()} == pytest.approx(
        {i: ns / MS for i, ns in want.items()})
    # without the reads nothing moves, and the drift moves idle by ms
    summary, spans = drifting_window(3.0)
    summary["ops"] = [o for o in summary["ops"] if o[0] != "Memcpy DtoH"]
    unmoved, _ = S.idle_by_span(summary, spans)
    assert max(abs(unmoved.get(i, 0) - v) for i, v in want.items()) > MS


def test_span_metrics_read_the_window(monkeypatch):
    summary, spans = made_up_window()
    monkeypatch.setattr(S, "program", lambda: (spans, {"syncs": 6}))
    got = {m: reader(m)(summary, None) for m in SPAN_METRICS}
    assert got == pytest.approx({
        "set_input_ms.train": (5 + 7) / 2,
        "idle_set_input_ms.train": (3 + 2 + 5) / 2,
        "idle_step_ms.train": (5 + 7 + 15) / 2,     # not the gc, not the read
        "idle_unspanned_ms.train": 10 / 2, "syncs.train": 3.0,
        # no infer.* span in a training window: nothing to read
        "idle_set_input_ms.infer": None, "idle_forward_ms.infer": None,
        "idle_unspanned_ms.infer": 10 / 2})


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_span_metrics_are_silent_without_the_recorder(monkeypatch, metric):
    summary, _ = made_up_window()
    old = types.ModuleType("cfen_vit_tpu_torch.utils.profiling")
    old.annotate = lambda name: None           # a program before the recorder
    monkeypatch.setitem(sys.modules, "cfen_vit_tpu_torch.utils.profiling", old)
    monkeypatch.setattr(sys.modules["cfen_vit_tpu_torch.utils"], "profiling",
                        old)
    assert S.program() is None
    assert reader(metric)(summary, None) is None


def test_time_ns_is_the_clock():
    """The recorder reads the wall clock time.time_ns() (the profiler's),
    not a monotonic one."""
    with cpu_profile():
        before = time.time_ns()
        with P.annotate("x"):
            pass
        after = time.time_ns()
    (_, _, _, _, a, b), = by_name(P.spans())
    assert before <= a <= b <= after
