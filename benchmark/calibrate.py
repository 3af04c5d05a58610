"""Readings that set the limits of `correct`, several seeds in one
process (not run by the benchmark's own runs):

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--window 8] [--ties 0] [--out readings.jsonl]

For each seed, the numbers of the cell's check between the program's
timed path and the plain reference at the cell's own sizes (the lower
reading is their largest over the seeds); a training cell's program
takes `--window` steps between its checked steps and the step after
them.  For each control seed also the control (the reference one
precision below the configuration's, in the program's place) and, in a
training cell, the fault of half of each batch left out (the reference
on the first half in the program's place).  A state left unchanged reads
1 on dparam3 and dparamw by their definition and needs no run.  With
`--ties N`, N more references, each with its hazy inputs moved by noise
of 1e-6, are held against the reference: how far a sound step reads
where ID-MRF's argmax and argmin change at near-ties.  One JSON line per
reading, then a summary line.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from . import check
from .run import Cell, ROOT, load_json


def _free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def train_readings(cell, seed, device, controls, window, ties):
    from .loops import train_closed as T
    cfg, mix = cell.config, cell.mix
    trainer, pool, state = T.setup_program(cfg, mix, seed, device)
    got = T.program_readings(trainer, pool, state, mix)
    n = mix["checked_steps"]
    for j in range(n, n + window):
        T.program_step(trainer, pool[j % len(pool)])
    batch = pool[(n + window) % len(pool)]
    snap, got["after"] = T.program_after(trainer, batch)
    del trainer, state
    _free(device)
    kw = dict(after=(snap, batch))
    want = T.reference_readings(cfg, mix, seed, pool, device, **kw)
    rows = [("program", check.train_checks(got, want, look=True))]
    others = []
    if controls:
        others += [("control", dict(control=mix["control"])),
                   ("half_batch", dict(half_batch=True))]
    others += [("tie", dict(noise=d)) for d in range(ties)]
    for kind, opts in others:
        _free(device)
        r = T.reference_readings(cfg, mix, seed, pool, device, **kw, **opts)
        rows.append((kind, check.train_checks(r, want, look=True)))
    _free(device)
    return rows


def infer_readings(cell, seed, device, controls, window, ties):
    from .loops import infer_closed as I
    model, pool_dev, pool = I.setup_program(cell.config, cell.mix, seed, device)
    b = cell.mix["batch"]
    keys = list(range(len(pool) // b))
    got = {}
    for k in keys:
        model.set_input({"B": pool[k * b:(k + 1) * b], "B_paths": []})
        got[k] = [model.test()["fake_A"]]
    del model
    _free(device)
    want = I.reference_outputs(cell.config, cell.mix, pool_dev, keys, seed, device)
    rows = [("program", {"worst_rmse_u8": check.worst_rmse_u8(got, want)})]
    if controls:
        ctrl = I.reference_outputs(cell.config, cell.mix, pool_dev, keys, seed,
                                   device, control=cell.mix["control"])
        rows.append(("control", {"worst_rmse_u8": check.worst_rmse_u8(
            {k: [v] for k, v in ctrl.items()}, want)}))
    _free(device)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--window", type=int, default=8,
                    help="training: steps between the checked ones and the "
                    "step after them")
    ap.add_argument("--ties", type=int, default=0,
                    help="training: draws of input noise of 1e-6 in the "
                    "reference, each held against the reference")
    args = ap.parse_args(argv)
    cell = Cell(args.workload, load_json(ROOT / "BENCHMARK.json"))
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    fn = train_readings if cell.mix["loop"] == "train_closed" else infer_readings
    sink = open(args.out, "a") if args.out else None
    worst = {}
    for seed in seeds + sorted(controls - set(seeds)):
        t = time.perf_counter()
        for kind, values in fn(cell, seed, device, seed in controls,
                              args.window, args.ties):
            line = {"cell": cell.name, "seed": seed, "kind": kind, **values,
                    "seconds": time.perf_counter() - t}
            print(json.dumps(line), flush=True)
            if sink:
                sink.write(json.dumps(line) + "\n")
                sink.flush()
            for k, v in values.items():
                if not isinstance(v, float):
                    continue
                pick = max if kind in ("program", "tie") else min
                worst.setdefault(kind, {})[k] = pick(worst.get(kind, {}).get(k, v), v)
    print(json.dumps({"cell": cell.name, "summary": worst}), flush=True)
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
