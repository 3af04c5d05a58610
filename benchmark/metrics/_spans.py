"""The traced window's device idle time, assigned to the program's spans.

The port records spans and counters while any torch profiler runs
(cfen_vit_tpu_torch/utils/profiling.py `spans()`, `counters()`): a span
is (name, parent_index, unit_id, thread_id, t0_ns, t1_ns) on
time.time_ns()'s clock, the clock the profiler gives the host's records.
The device's records (summary["ops"], start and duration in
microseconds) are meant to be on it too, but on the H100 they drift
from it by up to several ms over a window of seconds, either way
(PERF.md section 5).  The reckoning is the benchmark's own, so that a
change to the program cannot move it:

  * The main thread: the one whose outermost spans (not `gc`) cover the
    most time.
  * One clock.  Each device-to-host copy ("Memcpy DtoH") ends just before
    the host returns from waiting for it, at the end of a `sync.*` span
    of the main thread.  Where the window has as many such copies as
    such spans, the k-th copy's end is moved onto the k-th span's end,
    and every device time by the offset of its anchors, linear between
    them and held beyond the first and the last; elsewhere nothing is
    moved.  The host returns 0.04-0.4 ms after a copy ends (PERF.md), so
    moved device times sit late by that much.
  * The window.  trace.Window's window_s runs from just after the
    profiler started to the synchronize that closes the last unit, which
    returns once the last device record has ended: the window's trailing
    edge is the end of the last device record, its leading edge lies
    window_s before it.
  * Idle time.  The complement, inside the window, of the union of the
    device records' intervals; it sums to window_s - busy_s when every
    record lies in the window.
  * Assignment.  Each idle instant goes to the innermost span open at
    that instant on the main thread (spans on one thread nest), or to no
    span.  A span still open when spans() was read (t1_ns 0) is open to
    the window's end.

A program without the recorder (an older commit) has nothing to read:
`program()` is None and every metric of this file is left out.
"""

from __future__ import annotations

import bisect

GC = "gc"
SYNC = "sync."
DTOH = "Memcpy DtoH"


def program():
    """(spans, counters) of the port's recorder, or None."""
    try:
        from cfen_vit_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not (hasattr(profiling, "spans") and hasattr(profiling, "counters")):
        return None
    return profiling.spans(), profiling.counters()


def main_thread(spans):
    cover = {}
    for name, parent, _, tid, t0, t1 in spans:
        if parent < 0 and name != GC and t1:
            cover[tid] = cover.get(tid, 0) + t1 - t0
    return max(cover, key=cover.get) if cover else None


def host_clock(summary, spans, tid):
    """A function taking a device time (ns) onto the host's clock."""
    copies = sorted((start + dur) * 1e3 for name, start, dur in summary["ops"]
                    if name.startswith(DTOH))
    waits = sorted(t1 for name, _, _, t, _, t1 in spans
                   if t == tid and name.startswith(SYNC) and t1)
    if not copies or len(copies) != len(waits):
        return lambda t: t
    at = copies
    offset = [w - c for c, w in zip(copies, waits)]

    def move(t):
        i = bisect.bisect(at, t)
        if i == 0 or i == len(at):
            return t + offset[min(i, len(at) - 1)]
        f = (t - at[i - 1]) / max(at[i] - at[i - 1], 1)
        return t + offset[i - 1] + f * (offset[i] - offset[i - 1])
    return move


def device_ns(summary, spans, tid):
    """The device records' (start, end) in ns on the host's clock, by
    start."""
    move = host_clock(summary, spans, tid)
    return sorted((move(start * 1e3), move((start + dur) * 1e3))
                  for _, start, dur in summary["ops"])


def window_ns(summary, busy):
    """(leading, trailing) edge of the window in ns, or None."""
    if not busy or summary["window_s"] <= 0:
        return None
    end = max(e for _, e in busy)
    return end - summary["window_s"] * 1e9, end


def idle_intervals(busy, w0, w1):
    """The window's idle intervals (ns), in order."""
    out, at = [], w0
    for s, e in busy:
        s, e = max(s, w0), min(e, w1)
        if e <= at:
            continue
        if s > at:
            out.append((at, s))
        at = e
    if at < w1:
        out.append((at, w1))
    return out


def innermost(spans, tid, w1):
    """[(start, end, span index or None)] over time: the innermost span
    of thread `tid` open in each stretch."""
    marks = []
    for i, (_, _, _, t, t0, t1) in enumerate(spans):
        if t == tid:
            marks.append((t0, 1, i))
            marks.append((t1 or w1, 0, i))
    marks.sort()
    out, stack, prev = [], [], float("-inf")
    for t, opens, i in marks:
        if t > prev:
            out.append((prev, t, stack[-1] if stack else None))
            prev = t
        if opens:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
    out.append((prev, float("inf"), None))
    return out


def idle_by_span(summary, spans):
    """({span index or None: idle ns}, window idle ns) or None."""
    tid = main_thread(spans)
    busy = device_ns(summary, spans, tid)
    edges = window_ns(summary, busy)
    if edges is None:
        return None
    w0, w1 = edges
    idle = idle_intervals(busy, w0, w1)
    stretches = innermost(spans, tid, w1) if tid is not None else [
        (float("-inf"), float("inf"), None)]
    out, k = {}, 0
    for s, e in idle:
        while stretches[k][1] <= s:
            k += 1
        j = k
        while j < len(stretches) and stretches[j][0] < e:
            a, b = max(s, stretches[j][0]), min(e, stretches[j][1])
            if b > a:
                who = stretches[j][2]
                out[who] = out.get(who, 0.0) + (b - a)
            j += 1
    return out, sum(e - s for s, e in idle)


def within(spans, i, name):
    """Span i is `name` or lies inside it, and is neither a collection nor
    a device read (those are their own)."""
    own = spans[i][0]
    if own == GC or own.startswith(SYNC):
        return False
    while i >= 0:
        if spans[i][0] == name:
            return True
        i = spans[i][1]
    return False


def idle_ms_per_unit(summary, name):
    """Device-idle ms a unit assigned to span `name` and the spans inside
    it (`within`); name None: to no span.  None without such spans."""
    got = program()
    if got is None or not got[0]:
        return None
    spans = got[0]
    if name is not None and not any(s[0] == name for s in spans):
        return None
    split = idle_by_span(summary, spans)
    if split is None:
        return None
    ns = sum(v for i, v in split[0].items()
             if (i is None if name is None else
                 i is not None and within(spans, i, name)))
    return ns / 1e6 / summary["count"]


def span_ms_per_unit(summary, name):
    """Host ms a unit inside spans named `name`, clipped to the window."""
    got = program()
    if got is None:
        return None
    spans = got[0]
    edges = window_ns(summary, device_ns(summary, spans, main_thread(spans)))
    ns = [min(t1 or edges[1], edges[1]) - max(t0, edges[0])
          for n, _, _, _, t0, t1 in spans if n == name] if edges else []
    if not ns:
        return None
    return sum(max(0, v) for v in ns) / 1e6 / summary["count"]


def counter_per_unit(summary, name):
    got = program()
    if got is None or name not in got[1]:
        return None
    return got[1][name] / summary["count"]
