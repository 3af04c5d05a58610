"""Closed-loop inference of every output: loops/infer_closed.py's loop
(the same set-up, pool, warm batches, window, sample of batches and
fake_A kept from them) on a wrapper without --out_all, whose `test()`
returns every branch's uint8 output (fake_A, fake_R, fake_S) and the
input it was given (real_B), then one more pass over the pool after the
window, whose four outputs are all kept.

The window keeps what infer_closed.py keeps, fake_A alone: keeping more
of the wrapper's host arrays, or copies of them, changes where the host's
heap puts the next batch's arrays, and its pageable copies then fault
their pages afresh (PERF.md section 6).  Once the window has closed and
its peak is read, the wrapper runs every pool batch once more through
the same call, untimed.  The plain reference then gives fake_A, fake_R
and fake_S (its d, r and s: every branch, float32, TF32 off, the same
truncating uint8 conversion) and real_B (the pool's own batch):
`worst_rmse_u8` is the worst image over the window's fake_A and the
last pass's four outputs.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import check
from ..trace import Window
from .common import plain, stage, sync
from .infer_closed import sample, setup_program, weights, work

# the reference generator's branch -> the wrapper's visual
VISUALS = {"d": "fake_A", "r": "fake_R", "s": "fake_S"}


def reference_outputs(config, mix, pool_u8, keys, seed, device,
                      control=None) -> dict:
    """{(pool batch, visual): uint8 NHWC} of the plain reference (float32,
    TF32 off; `control` one precision below), real_B the batch itself."""
    g = weights(config, mix, pool_u8, seed, device)
    b, out = mix["batch"], {}
    with plain(control), torch.no_grad():
        for k in keys:
            x = pool_u8[k * b:(k + 1) * b]
            out[k, "real_B"] = x.cpu().numpy()
            y = g(x.permute(0, 3, 1, 2).float() / 127.5 - 1.0)
            for branch, name in VISUALS.items():
                out[k, name] = ((y[branch] + 1.0) * 127.5).to(
                    torch.uint8).permute(0, 2, 3, 1).cpu().numpy()
    return out


def every_output(model, batches, paths) -> dict:
    """{(pool batch, visual): [uint8 NHWC]}: each batch once through the
    wrapper's `test()`, all four outputs kept (a missing one as an empty
    array, which no reference matches)."""
    out = {}
    for k, batch in enumerate(batches):
        model.set_input({"B": batch, "B_paths": paths})
        got = model.test()
        for name in ("real_B", *VISUALS.values()):
            out[k, name] = [got.get(name, np.empty(0, np.uint8))]
    return out


def _per_output(got: dict, want: dict) -> dict:
    """worst_rmse_u8 of each visual alone, for the readings."""
    return {f"worst_rmse_u8.{n}": check.worst_rmse_u8(
        {k: v for k, v in got.items() if k[1] == n},
        {k: v for k, v in want.items() if k[1] == n})
        for n in ("real_B", *VISUALS.values())}


def run(config, mix, seed, seconds, trace, device, t0) -> dict:
    stage(t0, "imports")
    model, pool_dev, pool = setup_program(config, mix, seed, device)
    stage(t0, "model built")
    b = mix["batch"]
    n_pool = len(pool) // b
    batches = [pool[k * b:(k + 1) * b] for k in range(n_pool)]
    paths = [f"hazy_{k:03d}.png" for k in range(b)]
    for k in range(mix["warm_batches"]):
        model.set_input({"B": batches[k % n_pool], "B_paths": paths})
        model.test()
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0
    stage(t0, "warm batches")

    keep = sample(seed, n_pool, mix["sample_extra"])
    kept, lat, failed, i = {}, [], 0, 0

    def one():
        nonlocal i, failed
        k = i % n_pool
        t = time.perf_counter()
        try:
            model.set_input({"B": batches[k], "B_paths": paths})
            out = model.test()["fake_A"]
        except RuntimeError:
            failed += 1
        else:
            lat.append(time.perf_counter() - t)
            if i in keep:
                kept.setdefault((k, "fake_A"), []).append(out)
        i += 1

    summary = None
    if trace:
        with Window(mix["trace_batches"]) as w:
            for _ in range(mix["trace_batches"]):
                one()
        summary = w.summary
        window_s = summary["window_s"]
    else:
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            one()
        window_s = time.perf_counter() - start
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else 0)
    done = i - failed
    if any((k, "fake_A") not in kept for k in range(min(i, n_pool))):
        failed = max(failed, 1)
    for key, outs in every_output(model, batches, paths).items():
        kept.setdefault(key, []).extend(outs)
    del model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    stage(t0, "window closed")
    want = reference_outputs(config, mix, pool_dev, range(n_pool), seed,
                             device)
    stage(t0, "reference")
    return {"setup_s": setup_s, "attempted": i, "failed": failed,
            "values": {"infer_img_per_s": done * b / window_s,
                       "infer_p95_ms": 1e3 * float(np.percentile(lat, 95))
                       if lat else float("inf"),
                       "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s},
            "memory_peak_bytes": peak, "summary": summary,
            "work": work(config, mix) if trace else None,
            "checks": {"worst_rmse_u8": check.worst_rmse_u8(kept, want)}}


def readings(cell, seed, device, controls, window) -> list:
    """[(kind, numbers)] for calibrate_loops.py: every pool batch once
    through the wrapper against the reference and, with `controls`, the
    control in the program's place."""
    from ..calibrate import _free
    model, pool_dev, pool = setup_program(cell.config, cell.mix, seed, device)
    b = cell.mix["batch"]
    keys = list(range(len(pool) // b))
    got = every_output(model, [pool[k * b:(k + 1) * b] for k in keys], [])
    del model
    _free(device)
    want = reference_outputs(cell.config, cell.mix, pool_dev, keys, seed,
                             device)
    rows = [("program", {"worst_rmse_u8": check.worst_rmse_u8(got, want),
                         **_per_output(got, want)})]
    if controls:
        ctrl = {k: [v] for k, v in reference_outputs(
            cell.config, cell.mix, pool_dev, keys, seed, device,
            control=cell.mix["control"]).items()}
        rows.append(("control", {"worst_rmse_u8": check.worst_rmse_u8(
            ctrl, want), **_per_output(ctrl, want)}))
    _free(device)
    return rows
