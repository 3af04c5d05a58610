"""Times and profiles the GAN training step on the card.

    python -m cfen_vit_tpu_torch.train.profile_step [--dtypes float32,bfloat16]
        [--batch 4] [--steps 3] [--out DIR]

The canonical v3 generator (n_feats 24, hidden_dim_ratio 4, patch 32,
loadSize 256) at 512x512 with seeded random weights, `GanTrainer` as the
train CLI builds it (remat branch, pool 50), on a seeded batch of
uint8-representable images made on the host.  Per dtype it prints: the
step time (CUDA-synchronised host clock, mean of --steps steps after two
warm-up steps), the peak device memory of a step, and a torch.profiler
split of one step's device time by kernel group (utils/profiling.py
`GROUPS`), with the device's busy share (the union of its records'
intervals over the step's wall time: overlapping kernels count once).
The groups and the top kernels are also written to
DIR/profile_step_<dtype>.json.  Needs one card; without one it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from dataclasses import replace

import numpy as np
import torch

from ..utils.profiling import busy_ns, device_intervals, kernel_split

def _trainer(dtype: str, batch: int):
    from ..config import Config
    from ..train.trainer import GanTrainer
    cfg = replace(Config(), name="profile", n_feats=24, hidden_dim_ratio=4,
                  patch_size=32, loadSize=256, batchSize=batch, sb=True,
                  compute_dtype=dtype)
    return GanTrainer(cfg, torch.device("cuda"))


def _batch(batch: int, side: int = 512, seed: int = 0) -> dict:
    rng = np.random.RandomState(seed)
    out = {k: rng.randint(0, 256, (batch, side, side, 1 if k == "S" else 3))
           .astype(np.float32) / 127.5 - 1.0 for k in "BARS"}
    out["B_paths"] = [f"x{i}.png" for i in range(batch)]
    return out


def profile(dtype: str, batch: int, steps: int, out_dir: str) -> dict:
    tr = _trainer(dtype, batch)
    data = _batch(batch)

    def step():
        tr.set_input(data)
        tr.optimize_parameters()

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    from torch.profiler import ProfilerActivity, profile as tprofile
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.time_ns()
        step()
        torch.cuda.synchronize()
        t1 = time.time_ns()
    split = kernel_split(prof.key_averages())
    res = {"dtype": dtype, "batch": batch, "step_s": times,
           "mean_step_s": float(np.mean(times)), "peak_gib": peak,
           "profiled_step_wall_ms": (t1 - t0) / 1e6,
           "kernel_ms": split["kernel_ms"],
           "busy_share": busy_ns(device_intervals(prof), t0, t1) / (t1 - t0),
           "kernels": split["launches"],
           "groups_ms": split["groups_ms"], "top": split["top"],
           "losses": tr.get_current_losses()}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_step_{dtype}.json"), "w") as fh:
        json.dump(res, fh, indent=1)
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtypes", default="float32,bfloat16")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs an NVIDIA card")
    torch.backends.cudnn.allow_tf32 = False    # --precision highest
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for dtype in args.dtypes.split(","):
        r = profile(dtype, args.batch, args.steps, args.out)
        print(f"{dtype} batch {r['batch']}: {r['mean_step_s']:.4f} s/step "
              f"(steps {[round(t, 4) for t in r['step_s']]}), peak "
              f"{r['peak_gib']:.2f} GiB; profiled step {r['profiled_step_wall_ms']:.1f}"
              f" ms wall, {r['kernel_ms']:.1f} ms of kernels ({r['kernels']} "
              f"launches), busy {100 * r['busy_share']:.1f}%")
        for g, ms in r["groups_ms"].items():
            print(f"  {g}: {ms:.3f} ms ({100 * ms / r['kernel_ms']:.1f}%)")
        for ms, count, name in r["top"][:12]:
            print(f"    {ms:9.3f} ms  x{count:<5d} {name}")
        del r
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
