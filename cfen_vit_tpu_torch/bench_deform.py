"""Benchmark of the deformable convolution (counterpart of
scripts/bench_deform.py).

    python -m cfen_vit_tpu_torch.bench_deform [--iters 30] [--dtype bfloat16]
        [--paths cuda,plain] [--gpu_ids 0]

For each geometry and path it times the DCNv2 forward and the forward plus
backward (all five grads: x, offset, mask, w, b) and prints one JSON line
with the JAX script's fields.  Paths: `cuda` is `modulated_deform_conv`
on the card (K6, csrc/deform.cu, whose backward recomputes through the
plain version), `plain` is `deform_plain`.  On the card the times are
CUDA events around `--iters` calls after two warm-ups, per call; "MFU" is
the GEMM's 2*N*OH*OW*K^2*C*O operations per second over the card's
published peak for the dtype (67 TFLOP/s float32 outside the tensor
cores, 989 bf16; H100 SXM), printed as `peak_tflops`.  `--gpu_ids -1`
runs the plain path on the CPU, timed by the host clock, with no MFU.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .config import select_device, set_precision
from .ops import cuda_deform
from .ops.deform_conv import deform_plain, modulated_deform_conv

GEOMETRIES = [
    # (batch, H, W, Cin, Cout, kernel): DCNv2 in backbone stages at
    # mid resolution and 48-256 channels, as scripts/bench_deform.py has them
    (8, 128, 128, 64, 64, 3),
    (8, 64, 64, 128, 128, 3),
    (8, 32, 32, 256, 256, 3),
    (4, 256, 256, 48, 48, 3),
]
PEAK_TFLOPS = {"float32": 67.0, "bfloat16": 989.0}


def inputs(n, h, w, cin, cout, k, dtype, device):
    """The JAX script's seeded inputs (offsets randn*2, mask rand, w*0.05,
    zero bias), drawn in its NHWC/HWIO order and laid out NCHW/OIHW."""
    r = np.random.RandomState(0)
    x = r.randn(n, h, w, cin).transpose(0, 3, 1, 2)
    off = (r.randn(n, h, w, 2 * k * k) * 2.0).transpose(0, 3, 1, 2)
    mask = r.rand(n, h, w, k * k).transpose(0, 3, 1, 2)
    wt = (r.randn(k, k, cin, cout) * 0.05).transpose(3, 2, 0, 1)
    arrays = [x, off, mask, wt, np.zeros(cout)]
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)
            for a in arrays]


def _timer(device, iters):
    def run(fn):
        for _ in range(2):
            fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize(device)
            return start.elapsed_time(end) / iters
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    return run


def bench_one(geometry, path, dtype, device, iters) -> dict:
    n, h, w, cin, cout, k = geometry
    args = inputs(n, h, w, cin, cout, k, dtype, device)
    conv = modulated_deform_conv if path == "cuda" else deform_plain
    leaves = [a.clone().requires_grad_() for a in args]

    def fwd():
        with torch.no_grad():
            return conv(*args, 1, k // 2, 1)

    def fwd_bwd():
        out = conv(*leaves, 1, k // 2, 1)
        return torch.autograd.grad((out.float() ** 2).sum(), leaves)

    before = cuda_deform.launches
    timer = _timer(device, iters)
    t_fwd, t_bwd = timer(fwd), timer(fwd_bwd)
    flops = 2.0 * n * h * w * k * k * cin * cout
    on_card = device.type == "cuda"
    peak = PEAK_TFLOPS[str(dtype).split(".")[-1]] if on_card else None
    return {
        "geometry": f"{n}x{h}x{w}x{cin}->{cout} k{k}",
        "path": path,
        "dtype": str(dtype).split(".")[-1],
        "fwd_ms": t_fwd,
        "fwd_bwd_ms": t_bwd,
        "gemm_gflops": flops / 1e9,
        "fwd_eff_gflops": flops / t_fwd / 1e6,
        "fwd_eff_mfu_pct": 100 * flops / t_fwd / 1e9 / peak if peak else None,
        "peak_tflops": peak,
        "k6_launches": cuda_deform.launches - before,
        "iters": iters,
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
    }


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--paths", default="cuda,plain",
                    help="comma list of paths (cuda = K6, plain = deform_plain)")
    ap.add_argument("--gpu_ids", default="0", help="-1 is the CPU, N is cuda:N")
    args = ap.parse_args(argv)
    paths = [p for p in args.paths.split(",") if p]
    if set(paths) - {"cuda", "plain"}:
        ap.error(f"--paths takes cuda and plain, got {args.paths}")
    device = select_device(args.gpu_ids)
    if device.type == "cpu" and "cuda" in paths:
        ap.error("the cuda path needs a card: --gpu_ids -1 takes --paths plain")
    set_precision("highest")          # float32 plain products without TF32
    dtype = getattr(torch, args.dtype)
    rows = []
    for geometry in GEOMETRIES:
        for path in paths:
            row = bench_one(geometry, path, dtype, device, args.iters)
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    main()
