#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each printing its own lines; any failure raises (non-zero exit):

  1. environment: the card's name and power limit (nvidia-smi), torch,
     CUDA and nvcc versions, whether Pillow imports;
  2. build: compiles cfen_vit_tpu_torch/csrc/*.cu (ops/_build.py);
  3. kernels: K1 attention at the six ViT shapes of the canonical v3 model
     at batch 4, K3 tail and K4 stem at 512x512, K5's forward, do and dt
     kernels at the ID-MRF shapes of a 512x512 batch of 4 ([4,16384,256]
     relu3_1, [4,4096,512] relu4_1), K2 (the whole ViT token block) at
     the four blocks it takes at batch 4 (LViT L3 [16,256,384], GViT L1
     [4,256,384], and with CFEN_PALLAS_VIT_MIN_E=0 LViT L1 [256,256,96]
     and L2 [64,256,192]), in float32 and bfloat16, each against its plain
     PyTorch version on the card (max abs error, tolerance, median
     CUDA-event times, the card's bound: the products on the tensor
     cores, float32 as 3xTF32, or the bytes; K1 also beside
     F.scaled_dot_product_attention, K2 beside the unfused token path it
     replaces, with its device time from the profiler; K1 and SDPA also
     in five interleaved rounds, summed over the six shapes; K3, K4 and
     K5's do and dt beside the bound of the work their design runs);
     untimed, K1 at S 1024, 4096
     and 16384, a ragged S and head dims 12 to 256 (the defaults' 32 and
     128 among them), K3 and K4 at widths 4, 16 and 32, and K5 at a ragged
     P; then MrfCore against the dense mrf_core_plain on value and both
     grads, and the K1, K2, K3 and K4 autograd Functions' grads against the
     plain versions' autograd;
  4. inference end to end: a seeded full-width v3 model (n_feats 24,
     hidden_dim_ratio 4, patch 32, loadSize 256) with its ActNorms
     initialised on the first batch, saved as 1_net_G.pth, then
     `cfen_vit_tpu_torch.test --out_all --batchSize 4 --gpu_ids 0` over 8
     seeded 512x512 hazy PNGs, in float32 and bfloat16.  It checks the
     PNGs, that every kernel of the path launched during the CLI run, that
     fake_A is within 2/255 of the same model on the plain path, and that
     bfloat16 is above 35 dB PSNR against float32;
  5. training end to end: `cfen_vit_tpu_torch.train.cli.main` (--model
     dec_vit, the canonical v3 flags, --batchSize 4 --niter 1
     --niter_decay 1: 4 steps over 2 epochs) on 8 seeded 512x512
     hazy/clear/r/s quadruples, in float32 and bfloat16.  It checks that
     every G and D loss is finite, that G and D moved, that every kernel
     of the path launched (K1, K3, K4, K5 forward, do, dt) and the K1, K3,
     K4 backward recomputes ran, that the checkpoints exist, and that
     `cfen_vit_tpu_torch.test --out_all --which_epoch 2` reads the trained
     generator and writes 8 non-constant fake_A PNGs; it prints the steady
     s/step after step 0 and the peak device memory;
  6. serving with CFEN_PALLAS_VIT=1, in float32 and bfloat16:
     `cfen_vit_tpu_torch.serve` (build_model, warm, the batcher behind a
     ThreadingHTTPServer on 127.0.0.1, --max_batch 4) on phase 4's
     checkpoint answers 16 POSTs of the 8 hazy PNGs from 8 client threads
     (after the same burst, untimed, on a first server).
     Every reply must be a non-constant 512x512 PNG; float32 replies within
     2/255 of model.test() with K2 off, bf16 above 35 dB PSNR against
     float32; K2 and K1 must launch.  It prints /healthz, p50/p90 latency,
     req/s, the X-*-Ms split and model.test() img/s with K2 on and off,
     runs --self_ensemble on a batch of 4 and --chop on a 1024x768 image
     (finite, right shape; a 512 input under --chop is the plain
     forward), and `cfen_vit_tpu_torch.eval` on the card must give phase
     4's mean per-image bf16-vs-float32 PSNR within 0.01 dB;
  7. the deformable convolution: K6 against deform_plain at the four
     geometries of `cfen_vit_tpu_torch.bench_deform` (offsets randn*2) and
     at 2x64x64, 64->64 with offsets of std 12 (a third beyond the TPU
     kernel's ±12 window), in float32 and bfloat16 (kernel, plain and,
     where torchvision imports, torchvision.ops.deform_conv2d times; the
     bound and the profiler's device time);
     the five grads of the K6 autograd Function against autograd
     of deform_plain at 4x256x256, 48->48; then its main path, counted:
     a ModulatedDeformConvPack forward and backward on the card (one
     launch, one recompute, output equal to the Pack on deform_plain) and
     `bench_deform.main(--iters 5)`, whose lines must be finite and whose
     K6 path must launch;
  8. the JAX package's default flags (n_feats 32, hidden_dim_ratio 6, 4
     heads; 662,624,215 generator parameters: head dims 32 and 128, a
     16-channel stem and tails): phase 4's inference CLI run with its
     gates (2/255 against the plain path, 35 dB bf16), then 2 training
     steps per dtype through the train CLI, one batch an epoch (finite
     losses, G and D moved, K1, K3, K4 and K5's three kernels launched and
     the recomputes run), each with its counts reset before and read after;
  9. the 17 other --model_G specs (models/registry.py), each at full width
     (n_feats 24, hidden_dim_ratio 4, patch 32, 4 heads, loadSize 256 for
     the half-res v5 and 512 for the full-res trunk: a 512x512 input) and
     batch 2 through DehazingModel from parse_args (its own --model where
     it has one, e.g. dec_mgvit for dec_ipt): seeded weights, ActNorms
     initialised on the batch, saved as .pth and loaded through setup().
     Gates: float32 every visual (fake_A_refined too) within 2/255 of the
     same model on the plain versions; bf16 fake_A above 35 dB against
     float32 (a spec whose plain path in bf16 misses too, with the kernels
     at most BF16_PLAIN_DB below it, is logged as a finding instead); the
     --out_all fake_A within 1/255 of the all-output run's; K1 (but for
     iid_cnn_crs), K3 and K4 launched in both dtypes; no constant image.
     A `{"variants": ...}` line holds each spec's parameters, launches,
     differences, PSNR and model.test() ms.  Then phase 4's inference CLI
     with its gates for iid_hlgvit_crs_gd4_cfs (--loadSize 512) and for
     --model dec_mgvit (dec_ipt: fake_A is the refined output, no d-only);
 10. the trainers, at full width (n_feats 24, hidden_dim_ratio 4, patch
     32, 4 heads, a 512x512 input, batch 4, --remat --remat_mode branch):
     the train CLI for --model decr_vit, decs_vit, decn_vit, vit
     (--dataset_mode vit) and dec_mgvit in float32 and bfloat16, 2 steps
     each over 4 of phase 5's kind of quadruples, the float32 run saving
     checkpoints that the test CLI reads back (4 non-constant fake_A
     PNGs). Gates: finite losses, the JAX trainer's loss keys, every G and
     D tensor moved but those of generator modules no loss reaches
     (models/generator.py `unreached_modules`), which stay; K1, K3 and K4
     launched and recomputed; K5 launched where the loss set has ID-MRF
     (decr, decs, decn) and not in vit and dec_mgvit. Each model's float32
     step from its seeded weights on a resident batch with the kernels
     against the same step on the plain versions, on cuDNN's deterministic
     algorithms (each loss term within 1e-3 relative; ||g - p|| / ||p||
     within 1e-2 over G and 5e-4 over each D, and each tensor within 1e-1
     of its norm plus 1e-3 of the network's rms tensor norm, the worst
     tensor logged). Then --model dec_vit on the non-v3
     iid_hlgvit_crs_gd4_cfs (float32, the same gates); --grad_accum 2 on
     the canonical v3 against accum 1 from the same weights (pools take 4
     images, L2_a, ssim_a, GAN_a, vgg_a within 5e-3, p halved, a lower
     peak); the EpdnTrainer at batch 4, 512x512, float32, 2 steps (finite
     losses, the parameters moved). It logs each run's s/step after step 0
     and peak memory, and a `{"trainers": ...}` line.

Phases 1-5 run with K2 off (CFEN_PALLAS_VIT unset), as by default.
The last two lines are a JSON object of the kernels' results and
{"ok": true, "device": {...}}.  Without CUDA it exits 1 and prints neither.
"""

from __future__ import annotations

import glob
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from collections import defaultdict
from contextlib import ExitStack, redirect_stdout
from dataclasses import replace
from unittest import mock

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
BATCH, SIDE, N_IMAGES, SEED = 4, 512, 8, 0
# (atol, rtol) of kernel vs plain on the card.  float32: the two differ only
# in summation order.  bfloat16: both round to bf16 at the same places, so
# an element can differ by a rounding flip of an intermediate, ~2 ulps.
TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2e-2, 1e-2)}
KERNELS = {   # name -> (source, TPU kernel it replaces)
    "attention": ("cfen_vit_tpu_torch/csrc/attn.cu",
                  "cfen_vit_tpu/ops/pallas_attn.py:55"),
    "tail": ("cfen_vit_tpu_torch/csrc/tail.cu",
             "cfen_vit_tpu/ops/pallas_tail.py:69"),
    "stem": ("cfen_vit_tpu_torch/csrc/stem.cu",
             "cfen_vit_tpu/ops/pallas_stem.py:127"),
    "mrf_fwd": ("cfen_vit_tpu_torch/csrc/mrf.cu",
                "cfen_vit_tpu/ops/pallas_mrf.py:152"),
    "mrf_bwd_do": ("cfen_vit_tpu_torch/csrc/mrf.cu",
                   "cfen_vit_tpu/ops/pallas_mrf.py:266"),
    "mrf_bwd_dt": ("cfen_vit_tpu_torch/csrc/mrf.cu",
                   "cfen_vit_tpu/ops/pallas_mrf.py:287"),
    "fused_vit": ("cfen_vit_tpu_torch/csrc/vit.cu",
                  "cfen_vit_tpu/ops/pallas_vit.py:143"),
    "deform": ("cfen_vit_tpu_torch/csrc/deform.cu",
               "cfen_vit_tpu/ops/pallas_deform.py:200"),
}
# K2 against its twin: (atol as a share of the largest |output|, rtol).
# float32: summation order through eight chained linears of depth up to
# 1536; bf16: both round at the same points, and a rounding flip of an
# intermediate moves an output by about one bf16 ulp of the residual
# stream, whose largest values set the atol.
K2_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2 ** -7, 1e-2)}
# K2's grads (a recompute through the unfused pipeline, as the JAX VJP
# does) against autograd of its twin, per tensor in relative norm.
# float32: summation order, bar 1e-4.  bf16: the two are different bf16
# backward pipelines (the twin's passes through float32 matmuls), so each
# K2 grad must lie within twice the twin's own bf16 error against the
# float32 grads (plus 1e-3), which holds when both are within their
# rounding noise of the float32 result.
K2_GRAD_BAR = 1e-4
# the ID-MRF layers of a 512x512 batch of 4: relu3_1 and relu4_1
MRF_SHAPES = ((BATCH, (SIDE // 4) ** 2, 256), (BATCH, (SIDE // 8) ** 2, 512))
# K1 off the canonical model's shapes, checked untimed ([N, S, E], heads):
# S 1024, a ragged S, head dims 16 and 64; the defaults' 32 and 128, the
# padded 12 (8-byte cp.async chunks in bf16) and 40, 256, S 4096 and
# 16384; the wide heads 320 and 512 and the odd 5 and 33 (padded to even
# in bf16)
K1_EXTRA = (((4, 1024, 384), 4), ((3, 100, 96), 4), ((2, 256, 64), 4),
            ((2, 256, 256), 4), ((16, 256, 128), 4), ((4, 256, 512), 4),
            ((3, 100, 96), 8), ((2, 256, 160), 4), ((2, 64, 512), 2),
            ((2, 4096, 128), 4), ((1, 16384, 64), 2), ((2, 100, 640), 2),
            ((2, 300, 1024), 2), ((2, 100, 20), 4), ((2, 256, 132), 4))
# K3's input and K4's stem widths checked untimed: n_feats 8, the
# defaults' 16 and n_feats 64's 32
WIDTHS_EXTRA = (4, 16, 32)
MRF_EXTRA = ((2, 1000, 256),)
MRF_LAYERS = {MRF_SHAPES[0]: "relu3_1", MRF_SHAPES[1]: "relu4_1"}
# K5 against its twins.  Forward statistics: both sum cos in float32 from
# the same inputs, in another order (rtol 1e-4); an index may differ only
# where its value ties the twin's within that tolerance.  do/dt: float32
# sums over P terms in another order; bf16 outputs by a rounding flip;
# atol is that share of the largest |value|.
MRF_TOL = {"float32": (1e-3, 1e-4), "bfloat16": (2e-2, 1e-2)}
# the card's published peaks (H100 SXM, dense): TF32 and bf16 tensor
# cores, float32 FFMA outside them, HBM3.  A float32 product at float32
# accuracy runs fastest as three TF32 passes (3xTF32, 165 TFLOP/s against
# FFMA's 67), so that is float32's rate in every bound
PEAK_TF32 = 495e12
PEAK_FFMA = 67e12
PEAK_FLOPS = {"float32": PEAK_TF32 / 3, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
# kernels whose device time phase 3 also reads from the profiler (a short
# kernel's CUDA-event time is set by the host's launch path): the part of
# the kernel's name it matches
CONV_KERNEL_NAMES = {"tail": "tail_", "stem": "stem_kernel"}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def phase_env(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    from cfen_vit_tpu_torch.ops import _build
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    try:
        import PIL
        pil = f"Pillow {PIL.__version__}"
    except ImportError:
        pil = "Pillow missing"
    log("env", f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{nvcc[-1]}, {pil}, device {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")


def phase_build():
    from cfen_vit_tpu_torch.ops import _build
    t0 = time.perf_counter()
    lib = _build.library()
    log("build", f"{lib._name} built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    kernel = ""
    with open(lib._name[:-3] + ".log") as fh:
        for line in fh:
            # the kernel's name and the start of its mangled template
            # arguments, e.g. "attn_kernel IfLi24ELb0E" (float, 24, false)
            named = re.search(r"entry function '[^']*?\d+([a-z_]+_kernel)([^']{0,24})", line)
            if named:
                kernel = f"{named.group(1)} {named.group(2)}"
            elif "Used" in line or "spill" in line:
                log("build", f"ptxas {kernel}: " + line.strip().split(": ", 1)[-1])


def time_ms(torch, fn, reps=20, warmup=3) -> float:
    """Median CUDA-event time of fn, synchronising after every launch."""
    for _ in range(warmup):
        fn()
        torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(flops: float, nbytes: float, dtype: str):
    """The least time the card could take: the larger of the products'
    operations over the fastest rate for the inputs' type (bf16 tensor
    cores; float32 as 3xTF32) and the bytes over HBM's."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def design_bound(dtype: str, cos_flops: float) -> float:
    """K5 do's or dt's least time in ms for the products its design runs:
    the cos product and the two-pass (bf16 hi + lo) dcos product, three
    bf16 passes at 989 TFLOP/s; in float32 both as 3xTF32, six TF32 passes
    at 495.  Logged only, beside the function's bound."""
    if dtype == "float32":
        return 6 * cos_flops / PEAK_TF32 * 1e3
    return 3 * cos_flops / PEAK_FLOPS["bfloat16"] * 1e3


def tail_design_ms(dtype: str, n: int, c: int, h: int, w: int, out_c: int) -> float:
    """K3's least time in ms for the products its design runs, every tile
    whole: bf16, 16 x 32 tiles of 49 taps x c rounded up to 16 x 8 padded
    out channels at 989 TFLOP/s; float32, FFMA over 32 x 32 tiles of 49 c
    out_c at 67 (csrc/tail.cu).  Logged beside the function's bound."""
    if dtype == "bfloat16":
        px = n * -(-h // 16) * 16 * -(-w // 32) * 32
        return 2.0 * px * 49 * -(-c // 16) * 16 * 8 / PEAK_FLOPS[dtype] * 1e3
    px = n * -(-h // 32) * 32 * -(-w // 32) * 32
    return 2.0 * px * 49 * c * out_c / PEAK_FFMA * 1e3


def stem_design_ms(torch, dtype: str, n: int, cm: int, h: int, w: int) -> float:
    """K4's least time in ms for the work its design runs at the kernel's
    own plan (`cuda_stem.plan`), halos included: per tile the head conv's
    75 FFMAs a channel (cm rounded up to 4) and position of h's region
    (tile plus halo 2) at 67 TFLOP/s, then, N in whole chunks of 8 NT, the
    two 3x3 convs over r1's region (plus halo 1) and the tile in whole
    16-row strips, K 9 cpad, on the tensor cores: bf16 at 989 TFLOP/s,
    float32 as three TF32 passes at 495 (csrc/stem.cu)."""
    from cfen_vit_tpu_torch.ops import cuda_stem
    th, tw, nt, _ = cuda_stem.plan(cm, getattr(torch, dtype))
    kstep = 16 if dtype == "bfloat16" else 8
    cpad, nc = -(-cm // kstep) * kstep, -(-cm // (8 * nt)) * 8 * nt
    tiles = n * -(-h // th) * -(-w // tw)

    def strips(rows, cols):
        return -(-(rows * cols) // 16) * 16
    # the head skips a chunk's channels past cm four at a time
    head_n = sum(min(8 * nt, -(-(cm - n0) // 4) * 4) for n0 in range(0, cm, 8 * nt))
    head = tiles * (th + 4) * (tw + 4) * 75 * head_n * 2.0 / PEAK_FFMA
    macs = tiles * (strips(th + 2, tw + 2) + strips(th, tw)) * 9 * cpad * nc
    if dtype == "bfloat16":
        return (head + 2.0 * macs / PEAK_FLOPS[dtype]) * 1e3
    return (head + 3 * 2.0 * macs / PEAK_TF32) * 1e3


def _k1_against_sdpa(torch, cases, rounds=5):
    """K1 and F.scaled_dot_product_attention summed over the six shapes,
    timed in `rounds` interleaved rounds per dtype (the order flips each
    round), so that drift between runs shows as the rounds' spread."""
    for dn in ("float32", "bfloat16"):
        sums = {"K1": [], "SDPA": []}
        for rnd in range(rounds):
            order = ("K1", "SDPA") if rnd % 2 == 0 else ("SDPA", "K1")
            for name in order:
                sums[name].append(sum(
                    time_ms(torch, lambda: (wrapper if name == "K1" else library)(*a))
                    for d, a, wrapper, library in cases if d == dn))
        wins = sum(k < l for k, l in zip(sums["K1"], sums["SDPA"]))
        log("kernel", f"attention {dn}, six shapes summed, {rounds} interleaved "
            f"rounds: K1 {', '.join(f'{v:.4f}' for v in sums['K1'])} ms "
            f"(median {statistics.median(sums['K1']):.4f}); SDPA "
            f"{', '.join(f'{v:.4f}' for v in sums['SDPA'])} ms (median "
            f"{statistics.median(sums['SDPA']):.4f}); K1 faster in {wins} of "
            f"{rounds} rounds")


def kernel_cases(torch, spec):
    """(kernel, label, wrapper, plain, args, flops, bytes per element size,
    library call or None) at the main path's shapes."""
    import torch.nn.functional as F
    from cfen_vit_tpu_torch.ops import cuda_attn, cuda_stem, cuda_tail
    g = torch.Generator(device="cuda").manual_seed(SEED)
    dev = "cuda"

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=dev) * std

    def sdpa(q, k, v, h):
        n, s, e = q.shape
        heads = [t.view(n, s, h, e // h).transpose(1, 2) for t in (q, k, v)]
        return F.scaled_dot_product_attention(*heads)

    cases = []
    for lvl in (1, 2, 3):
        lv = spec.lvit_spec(lvl)
        tiles = (spec.level_size(lvl) // spec.patch_size) ** 2
        gv = spec.gvit_spec(lvl, encoder=False)
        for label, vs, n in ((f"LViT L{lvl}", lv, BATCH * tiles),
                             (f"GViT L{lvl}", gv, BATCH)):
            s, e = vs.seq_length, vs.embedding_dim
            args = [randn(n, s, e) for _ in range(3)] + [vs.num_heads]
            cases.append(("attention", f"{label} [{n},{s},{e}] h{vs.num_heads}",
                          cuda_attn.block_attention, cuda_attn.attention_core,
                          args, 4.0 * n * s * s * e, 4.0 * n * s * e, sdpa))
    c, px = spec.stem_channels(), BATCH * SIDE * SIDE   # the stem's and tails' width
    for out_c in (3, 1):
        t2 = torch.relu(randn(BATCH, c, SIDE, SIDE))
        args = [t2, randn(out_c, c, 7, 7, std=(2 / (49 * c)) ** 0.5),
                randn(out_c, std=0.1)]
        cases.append(("tail", f"[{BATCH},{c},{SIDE},{SIDE}] -> {out_c}",
                      cuda_tail.tail_epilogue, cuda_tail.tail_plain, args,
                      2.0 * px * c * 49 * out_c, px * (c + out_c), None))
    x = torch.rand((BATCH, 3, SIDE, SIDE), generator=g, device=dev) * 2 - 1
    std3 = (2 / (9 * c)) ** 0.5
    args = [x, randn(c, 3, 5, 5, std=(2 / 75) ** 0.5), randn(c, std=0.1),
            randn(c, c, 3, 3, std=std3), randn(c, std=0.1),
            randn(c, c, 3, 3, std=std3), randn(c, std=0.1)]
    cases.append(("stem", f"[{BATCH},3,{SIDE},{SIDE}] -> {c}",
                  cuda_stem.fused_stem, cuda_stem.stem_plain, args,
                  2.0 * px * (3 * 25 * c + 2 * c * 9 * c), px * (3 + c), None))
    return cases


def _ms(v) -> str:
    """A time for a log line; None (a profiler trace that lost records,
    bench_cases.device_times) is "not measured"."""
    return "not measured" if v is None else f"{v:.4f} ms"


def _record(results, kernel, dn, err, ms, plain_ms, bound, library_ms=None,
            **summed):
    """Adds one shape's numbers to the (kernel, dtype) entry of the kernels
    line: measured times and the bound, summed over the shapes."""
    r = results.setdefault((kernel, dn), {
        "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
        "bound_by": bound[1], "library_ms": None})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["ms"] += ms
    r["plain_ms"] += plain_ms
    r["bound_ms"] += bound[0]
    if library_ms is not None:
        r["library_ms"] = (r["library_ms"] or 0.0) + library_ms
    for key, value in summed.items():   # None (not measured) stays None
        have = r.get(key, 0.0)
        r[key] = None if have is None or value is None else have + value


def _hold(torch, label, wrapper, plain, a, dn, untimed=False):
    """wrapper(*a) against plain(*a) under TOL, logged; returns (err, ok)."""
    got = wrapper(*a)
    torch.cuda.synchronize()
    ref = plain(*a)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    atol, rtol = TOL[dn]
    ok = bool(torch.allclose(got.float(), ref.float(), atol=atol, rtol=rtol))
    log("kernel", f"{label} {dn}{', untimed' if untimed else ''}: max_abs_err "
        f"{err:.3g} (atol {atol}, rtol {rtol}) {'ok' if ok else 'FAIL'}")
    return err, ok


def _hold_untimed(torch, cases):
    """Each (kernel, label, wrapper, plain, args) against its plain version
    in both dtypes, untimed; returns the failures."""
    failures = []
    for kernel, label, wrapper, plain, args in cases:
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            a = [t.to(dtype) if isinstance(t, torch.Tensor) else t for t in args]
            if not _hold(torch, f"{kernel} {label}", wrapper, plain, a, dn, True)[1]:
                failures.append(f"{kernel} {label} {dn}")
    return failures


def phase_kernels(torch, spec, results):
    """K1, K3, K4 against their plain versions; adds per (kernel, dtype)
    the max error and the summed times and bounds over the shapes."""
    from cfen_vit_tpu_torch.bench_cases import device_ms
    failures, k1_cases = [], []
    design_sums = defaultdict(float)
    with torch.inference_mode():
        for (kernel, label, wrapper, plain, args, flops, elems,
             library) in kernel_cases(torch, spec):
            for dtype in (torch.float32, torch.bfloat16):
                dn = str(dtype).split(".")[-1]
                a = [t.to(dtype) if isinstance(t, torch.Tensor) else t
                     for t in args]
                err, ok = _hold(torch, f"{kernel} {label}", wrapper, plain, a, dn)
                ms = time_ms(torch, lambda: wrapper(*a))
                plain_ms = time_ms(torch, lambda: plain(*a))
                lib_ms = library and time_ms(torch, lambda: library(*a))
                bound = bound_ms(flops, elems * a[0].element_size(), dn)
                design = _conv_design_ms(torch, kernel, dn, a)
                dev = (device_ms(lambda: wrapper(*a), CONV_KERNEL_NAMES[kernel])
                       if kernel in CONV_KERNEL_NAMES else None)
                lib = f", library {lib_ms:.4f} ms" if library else ""
                log("kernel", f"{kernel} {label} {dn}: kernel {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms{lib}, bound {bound[0]:.4f} ms ({bound[1]})"
                    + (f", design bound {design:.4f} ms" if design else "")
                    + (f", device {_ms(dev)} (profiler)"
                       if kernel in CONV_KERNEL_NAMES else ""))
                if design:
                    design_sums[(kernel, dn)] += design
                _record(results, kernel, dn, err, ms, plain_ms, bound,
                        lib_ms or None)
                if kernel == "attention":
                    k1_cases.append((dn, a, wrapper, library))
                if not ok:
                    failures.append(f"{kernel} {label} {dn}")
        for (kernel, dn), v in design_sums.items():
            log("kernel", f"{kernel} {dn}: design bound summed over the timed "
                f"shapes {v:.4f} ms")
        _k1_against_sdpa(torch, k1_cases)
        failures += _hold_untimed(torch, _k1_extra_cases(torch))
        failures += _hold_untimed(torch, _width_cases(torch))
    if failures:
        raise AssertionError(f"kernels disagree with plain: {failures}")


def _conv_design_ms(torch, kernel, dn, a):
    """K3's or K4's design bound for the arguments a; None for others."""
    if kernel == "tail":
        n, c, h, w = a[0].shape
        return tail_design_ms(dn, n, c, h, w, a[1].shape[0])
    if kernel == "stem":
        n, _, h, w = a[0].shape
        return stem_design_ms(torch, dn, n, a[1].shape[0], h, w)
    return None


def _k1_extra_cases(torch):
    """K1 at the K1_EXTRA shapes, as _hold_untimed takes them."""
    from cfen_vit_tpu_torch.ops import cuda_attn
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    return [("attention", f"[{n},{s},{e}] h{heads} (dh {e // heads})",
             cuda_attn.block_attention, cuda_attn.attention_core,
             [torch.randn(n, s, e, generator=g, device="cuda") for _ in range(3)]
             + [heads]) for (n, s, e), heads in K1_EXTRA]


def _width_cases(torch):
    """K3 and K4 at the stem and tail widths of other n_feats, at 2 x 128 x
    200 (ragged against both kernels' tiles), as _hold_untimed takes them."""
    from cfen_vit_tpu_torch.ops import cuda_stem, cuda_tail
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=g, device="cuda") * std
    cases = []
    for c in WIDTHS_EXTRA:
        x = torch.rand((2, 3, 128, 200), generator=g, device="cuda") * 2 - 1
        std3 = (2 / (9 * c)) ** 0.5
        cases.append(("stem", f"[2,3,128,200] -> {c}", cuda_stem.fused_stem,
                      cuda_stem.stem_plain,
                      [x, randn(c, 3, 5, 5, std=(2 / 75) ** 0.5), randn(c, std=0.1),
                       randn(c, c, 3, 3, std=std3), randn(c, std=0.1),
                       randn(c, c, 3, 3, std=std3), randn(c, std=0.1)]))
        t2 = torch.relu(randn(2, c, 128, 200))
        for out_c in (3, 1):
            cases.append(("tail", f"[2,{c},128,200] -> {out_c}",
                          cuda_tail.tail_epilogue, cuda_tail.tail_plain,
                          [t2, randn(out_c, c, 7, 7, std=(2 / (49 * c)) ** 0.5),
                           randn(out_c, std=0.1)]))
    return cases


def k2_cost(vspec, n, item):
    """Operations (the ten E x E linears, QK^T and PV, the two MLPs) and
    bytes (tokens in and out, the 5E^2 + 4EH + SE weights)."""
    s, e, h = vspec.seq_length, vspec.embedding_dim, vspec.hidden_dim
    flops = n * (10.0 * s * e * e + 4.0 * s * s * e + 8.0 * s * e * h)
    return flops, (2.0 * n * s * e + 5 * e * e + 4 * e * h + s * e) * item


def _log_totals(phase, results, kernel):
    """The kernels line's sums of one kernel, per dtype, as a log line."""
    for (name, dn), r in results.items():
        if name == kernel:
            log(phase, f"{kernel} {dn} summed over the timed shapes: kernel "
                f"{r['ms']:.4f} ms, device {_ms(r['device_ms'])} (profiler), "
                f"bound {r['bound_ms']:.4f} ms"
                + (f", unfused {r['unfused_ms']:.4f} ms" if "unfused_ms" in r else ""))


def phase_fused_vit(torch, spec, results):
    """K2 against its twin at its four blocks, beside the unfused token
    path (ViT.tokens with K2 off: cuBLAS linears and K1) it replaces."""
    from cfen_vit_tpu_torch.bench_cases import device_ms, k2_blocks, k2_case
    from cfen_vit_tpu_torch.ops import cuda_vit
    failures = []
    with torch.inference_mode():
        for label, vspec, n in k2_blocks(spec):
            for dtype in (torch.float32, torch.bfloat16):
                dn = str(dtype).split(".")[-1]
                vit, t = k2_case(vspec, n, dtype, SEED)
                w, heads = vit.fused_weights(), vspec.num_heads
                got = cuda_vit.fused_tokens(t, w, heads)
                torch.cuda.synchronize()
                ref = cuda_vit.fused_tokens_plain(t, w, heads)
                frac, rtol = K2_TOL[dn]
                top = ref.float().abs().max().item()
                err = (got.float() - ref.float()).abs().max().item()
                rel = ((got.float() - ref.float()).norm() / ref.float().norm()).item()
                ok = bool(torch.allclose(got.float(), ref.float(),
                                         atol=frac * top, rtol=rtol))
                ms = time_ms(torch, lambda: cuda_vit.fused_tokens(t, w, heads))
                plain_ms = time_ms(torch, lambda: cuda_vit.fused_tokens_plain(
                    t, w, heads))
                unfused_ms = time_ms(torch, lambda: vit.tokens(t))
                dev = device_ms(lambda: cuda_vit.fused_tokens(t, w, heads))
                cost = k2_cost(vspec, n, t.element_size())
                bound = bound_ms(*cost, dn)
                log("kernel", f"fused_vit {label} [{n},{vspec.seq_length},"
                    f"{vspec.embedding_dim}] h{heads} H{vspec.hidden_dim} {dn}: "
                    f"max_abs_err {err:.3g} of max |out| {top:.3g}, relative "
                    f"norm {rel:.3g} (atol {frac:.3g} x max, rtol {rtol}) "
                    f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, device "
                    f"{_ms(dev)} (profiler), twin {plain_ms:.4f} ms, unfused "
                    f"{unfused_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
                _record(results, "fused_vit", dn, err, ms, plain_ms, bound,
                        unfused_ms=unfused_ms, device_ms=dev)
                if not ok:
                    failures.append(f"fused_vit {label} {dn}")
                del vit, t, got, ref
    _log_totals("kernel", results, "fused_vit")
    if failures:
        raise AssertionError(f"K2 disagrees with its twin: {failures}")


def _mrf_inputs(torch, n, p, c, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.nn.functional.normalize(
        torch.randn(n, p, c, generator=g, device="cuda"), dim=-1).to(dtype)
        for _ in range(2)]


def _mrf_cotangent_inputs(torch, stats, p):
    """dk, dz as MrfCore's backward forms them for an upstream grad of 1."""
    m, z, _, k, q_star = stats
    n = k.shape[0]
    dk = (-1.0 / (k.mean(dim=1) * p)).contiguous()
    offs = torch.arange(n, device=k.device)[:, None] * p
    sum_kq = torch.zeros(n * p, device=k.device).index_add_(
        0, (q_star + offs).reshape(-1), k.reshape(-1)).view(n, p)
    return dk, (-dk[:, None] * sum_kq / z).contiguous()


def _check_mrf_stats(torch, o, t, got, ref):
    """Float statistics within rtol 1e-4; each index that differs from the
    twin's must tie it in value (cd for p*, cs for q*) within 1e-4."""
    from cfen_vit_tpu_torch.ops import cuda_mrf as M
    err, ok = 0.0, True
    for a, b in ((got[0], ref[0]), (got[1], ref[1]), (got[3], ref[3])):
        err = max(err, (a - b).abs().max().item())
        ok &= bool(torch.allclose(a, b, rtol=1e-4, atol=1e-6))
    m, z = ref[0], ref[1]
    of, tf = o.float(), t.float()
    pk, pr = got[2], ref[2]
    nq, qq = torch.nonzero(pk != pr, as_tuple=True)
    cd_k = M._cdist((of[nq, qq] * tf[nq, pk[nq, qq]]).sum(-1))
    cd_r = M._cdist((of[nq, qq] * tf[nq, pr[nq, qq]]).sum(-1))
    ok &= bool(torch.allclose(cd_k, cd_r, rtol=1e-4, atol=1e-6))
    qk, qr = got[4], ref[4]
    nn_, pp = torch.nonzero(qk != qr, as_tuple=True)

    def cs(q):
        cd = M._cdist((of[nn_, q] * tf[nn_, pp]).sum(-1))
        return M._exp_term(cd, m[nn_, q]) / z[nn_, q]
    ok &= bool(torch.allclose(cs(qk[nn_, pp]), cs(qr[nn_, pp]), rtol=1e-4,
                              atol=1e-9))
    return err, ok, len(nq) + len(nn_)


def phase_mrf_kernels(torch, results):
    """K5's three kernels against their twins at the ID-MRF shapes."""
    from cfen_vit_tpu_torch.ops import cuda_mrf as M
    failures = []
    sums = defaultdict(lambda: defaultdict(float))   # (kernel, dtype) -> totals
    with torch.inference_mode():
        for n, p, c in MRF_SHAPES + MRF_EXTRA:
            timed = (n, p, c) in MRF_SHAPES
            for dtype in (torch.float32, torch.bfloat16):
                dn = str(dtype).split(".")[-1]
                o, t = _mrf_inputs(torch, n, p, c, dtype, SEED)
                item = o.element_size()
                stat_bytes = n * p * (4 + 4 + 8 + 4 + 8)
                got = M.mrf_forward_stats(o, t)
                torch.cuda.synchronize()
                ref = M.mrf_forward_stats_plain(o, t)
                err, ok, flips = _check_mrf_stats(torch, o, t, got, ref)
                cos_flops = 2.0 * n * p * p * c
                if timed:
                    ms = time_ms(torch, lambda: M.mrf_forward_stats(o, t), 5, 1)
                    plain_ms = time_ms(torch, lambda: M.mrf_forward_stats_plain(
                        o, t), 5, 1)
                    bound = bound_ms(cos_flops, 2 * n * p * c * item + stat_bytes, dn)
                    times = (f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                             f"{bound[0]:.3f} ms ({bound[1]})")
                    _record(results, "mrf_fwd", dn, err, ms, plain_ms, bound)
                layer = MRF_LAYERS.get((n, p, c), "ragged P")
                log("kernel", f"mrf_fwd {layer} [{n},{p},{c}] {dn}: max_abs_err "
                    f"{err:.3g} (rtol 1e-4, atol 1e-6; {flips} index ties) "
                    f"{'ok' if ok else 'FAIL'}" + (times if timed else ", untimed"))
                if not ok:
                    failures.append(f"mrf_fwd [{n},{p},{c}] {dn}")
                m, z, _, k, q_star = ref
                dk, dz = _mrf_cotangent_inputs(torch, ref, p)
                args = (o, t, m, z, dz, q_star, dk)
                rtol, frac = MRF_TOL[dn]
                for name, kern, twin in (
                        ("mrf_bwd_do", M.mrf_bwd_do, M.mrf_bwd_do_plain),
                        ("mrf_bwd_dt", M.mrf_bwd_dt, M.mrf_bwd_dt_plain)):
                    outs = kern(*args)
                    torch.cuda.synchronize()
                    refs = twin(*args)
                    outs = outs if isinstance(outs, tuple) else (outs,)
                    refs = refs if isinstance(refs, tuple) else (refs,)
                    err, ok = 0.0, True
                    for a, b in zip(outs, refs):
                        a, b = a.float(), b.float()
                        atol = frac * b.abs().max().item()
                        err = max(err, (a - b).abs().max().item())
                        ok &= bool(torch.allclose(a, b, rtol=rtol, atol=atol))
                    if timed:
                        ms = time_ms(torch, lambda: kern(*args), 5, 1)
                        plain_ms = time_ms(torch, lambda: twin(*args), 5, 1)
                        bound = bound_ms(2 * cos_flops,
                                         3 * n * p * c * item + stat_bytes, dn)
                        design = design_bound(dn, cos_flops)
                        times = (f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                                 f"bound {bound[0]:.3f} ms ({bound[1]}), design "
                                 f"bound {design:.3f} ms")
                        _record(results, name, dn, err, ms, plain_ms, bound)
                        for key, v in (("ms", ms), ("plain", plain_ms),
                                       ("bound", bound[0]), ("design", design)):
                            sums[name, dn][key] += v
                    log("kernel", f"{name} {layer} [{n},{p},{c}] {dn}: max_abs_err "
                        f"{err:.3g} (rtol {rtol}, atol {frac} x max) "
                        f"{'ok' if ok else 'FAIL'}" + (times if timed else ", untimed"))
                    if not ok:
                        failures.append(f"{name} [{n},{p},{c}] {dn}")
    for (name, dn), v in sums.items():
        log("kernel", f"{name} {dn} summed over relu3_1 and relu4_1: kernel "
            f"{v['ms']:.3f} ms, plain {v['plain']:.3f} ms, bound "
            f"{v['bound']:.3f} ms, design bound {v['design']:.3f} ms "
            f"({'six TF32' if dn == 'float32' else 'three bf16'} passes)")
    if failures:
        raise AssertionError(f"K5 kernels disagree with their twins: "
                             f"{failures}")


def _grads(torch, fn, args, seed=9):
    leaves = [a.detach().clone().requires_grad_() if isinstance(
        a, torch.Tensor) else a for a in args]
    out = fn(*leaves)
    if out.dim() == 0:
        cot = torch.ones_like(out)
    else:
        g = torch.Generator(device="cuda").manual_seed(seed)
        cot = torch.randn(out.shape, generator=g, device="cuda").to(out.dtype)
    grads = torch.autograd.grad(out, [a for a in leaves if isinstance(
        a, torch.Tensor)], cot)
    return out, grads


def phase_autograd(torch, spec):
    """MrfCore against the dense plain core, and K1, K2, K3, K4 under
    autograd against their plain versions' autograd, on value and grads."""
    from cfen_vit_tpu_torch.bench_cases import k2_blocks, k2_case
    from cfen_vit_tpu_torch.ops import cuda_mrf as M
    from cfen_vit_tpu_torch.ops import cuda_vit
    cases = []
    for n, p, c in MRF_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            cases.append((f"MrfCore [{n},{p},{c}]", dtype, M.mrf_core,
                          M.mrf_core_plain,
                          _mrf_inputs(torch, n, p, c, dtype, SEED + 1)))
    picks = {"attention": "LViT L1", "tail": "-> 3", "stem": "-> 12"}
    for (kernel, label, wrapper, plain, args, *_rest) in kernel_cases(
            torch, spec):
        if picks[kernel] in label:
            for dtype in (torch.float32, torch.bfloat16):
                cases.append((f"{kernel} {label}", dtype, wrapper, plain,
                              [a.to(dtype) if isinstance(a, torch.Tensor)
                               else a for a in args]))
    label, vspec, n = k2_blocks(spec)[1]           # GViT L1
    k2_heads = vspec.num_heads
    for dtype in (torch.float32, torch.bfloat16):
        vit, t = k2_case(vspec, n, dtype, SEED + 2)
        cases.append((f"fused_vit {label} [{n},{vspec.seq_length},"
                      f"{vspec.embedding_dim}]", dtype,
                      lambda x, *w: cuda_vit.fused_tokens(x, w, k2_heads),
                      lambda x, *w: cuda_vit.fused_tokens_plain(x, w, k2_heads),
                      [t] + [p.detach() for p in vit.fused_weights()]))
        del vit
    failures = []
    for label, dtype, fn, plain, args in cases:
        dn = str(dtype).split(".")[-1]
        out, grads = _grads(torch, fn, args)
        ref, ref_grads = _grads(torch, plain, args)
        rtol, frac = MRF_TOL[dn]
        if fn is M.mrf_core:
            # an argmin or argmax near-tie may resolve to another index in
            # the kernel than in torch.min/max, which moves that row's or
            # column's cotangent whole; so the MRF grads are held in
            # relative norm (1e-4 float32, 1e-2 bf16), with the flips shown
            got_st = M.mrf_forward_stats(*args)
            ref_st = M.mrf_forward_stats_plain(*args)
            flips = [int((got_st[i] != ref_st[i]).sum()) for i in (2, 4)]
            bar = 1e-4 if dtype == torch.float32 else 1e-2
            err = max(((a.float() - b.float()).norm() / b.float().norm()).item()
                      for a, b in zip(grads, ref_grads))
            ok = (abs(out.item() - ref.item()) <= 1e-4 * abs(ref.item())
                  and err < bar)
            log("autograd", f"{label} {dn}: value {out.item():.6g} vs "
                f"{ref.item():.6g}, grads relative norm err {err:.3g} (bar "
                f"{bar}; p*, q* index flips {flips}) {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"{label} {dn}")
            continue
        if label.startswith("fused_vit"):
            frac, vrtol = K2_TOL[dn]

            def rel(xs, ys):
                return [((a.float() - b.float()).norm() / b.float().norm()).item()
                        for a, b in zip(xs, ys)]
            # the VJP is that of the unfused pipeline, as in JAX _fused_bwd
            vjp = rel(grads, _grads(torch, lambda x, *w: cuda_vit.tokens_reference(
                x, w, k2_heads), args)[1])
            err = rel(grads, ref_grads)
            if dtype == torch.float32:
                bars = [K2_GRAD_BAR] * len(err)
                noise = "float32"
            else:
                f32 = _grads(torch, plain, [a.float() for a in args])[1]
                twin_err = rel(ref_grads, f32)
                bars = [2 * e + 1e-3 for e in twin_err]
                noise = (f"the twin's own bf16 error against float32 up to "
                         f"{max(twin_err):.3g}, K2's {max(rel(grads, f32)):.3g}")
            ok = (bool(torch.allclose(out.float(), ref.float(), rtol=vrtol,
                                      atol=frac * ref.float().abs().max().item()))
                  and max(vjp) < 1e-5 and all(e < b for e, b in zip(err, bars)))
            log("autograd", f"{label} {dn}: grads of t and 17 weights against "
                f"the twin's autograd, relative norm up to {max(err):.3g} (t "
                f"{err[0]:.3g}; {noise}); against the unfused pipeline's own "
                f"autograd {max(vjp):.3g} {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"{label} {dn}")
            del out, grads, ref, ref_grads
            continue
        grad_atol = [frac * b.float().abs().max().item() for b in ref_grads]
        atol, vrtol = TOL[dn]
        ok = bool(torch.allclose(out.float(), ref.float(), atol=atol,
                                 rtol=vrtol))
        err = 0.0
        for a, b, atol in zip(grads, ref_grads, grad_atol):
            a, b = a.float(), b.float()
            err = max(err, ((a - b).abs().max() / b.abs().max()).item())
            ok &= bool(torch.allclose(a, b, rtol=rtol, atol=atol))
        log("autograd", f"{label} {dn}: value {out.float().sum().item():.6g} "
            f"vs {ref.float().sum().item():.6g}, grads max err / max "
            f"{err:.3g} (rtol {rtol}, atol "
            f"{', '.join(f'{x:.3g}' for x in grad_atol)}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{label} {dn}")
        del out, grads, ref, ref_grads
    if failures:
        raise AssertionError(f"autograd disagrees with plain: {failures}")


def write_hazy_pngs(root: str, train: bool = False) -> list:
    """Seeded smooth scenes J with transmission t through the atmospheric
    scattering model I = J t + A (1 - t), as uint8 PNGs under root/hazy/;
    with `train` also J under clear/ and r/ and t under s/."""
    from PIL import Image
    import torch
    import torch.nn.functional as F
    rng = np.random.RandomState(SEED)
    dirs = ("hazy", "clear", "r", "s") if train else ("hazy",)
    for d in dirs:
        os.makedirs(os.path.join(root, d))
    paths = []
    for i in range(N_IMAGES):
        low = torch.from_numpy(rng.rand(1, 4, 16, 16).astype(np.float32))
        up = F.interpolate(low, size=(SIDE, SIDE), mode="bilinear",
                           align_corners=False)[0].numpy()
        scene, t = up[:3].transpose(1, 2, 0), 0.3 + 0.6 * up[3][..., None]
        hazy = scene * t + 0.9 * (1 - t) + rng.randn(SIDE, SIDE, 3) * 0.01
        images = {"hazy": hazy, "clear": scene, "r": scene,
                  "s": np.repeat(t, 3, axis=2)}
        for d in dirs:
            path = os.path.join(root, d, f"im_{i:02d}.png" if train
                                else f"hazy_{i:02d}.png")
            Image.fromarray(np.clip(images[d] * 255, 0, 255).astype(
                np.uint8)).save(path)
        paths.append(os.path.join(root, "hazy", f"im_{i:02d}.png" if train
                                  else f"hazy_{i:02d}.png"))
    return paths


def read_png(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def phase_e2e(torch, spec, tmp, tag="e2e", model_flag="dec_vit"):
    """The inference CLI (`--model model_flag --model_G spec.name --out_all`) in
    float32 and bfloat16 under `tmp` (kept for the serve phase); returns
    the launch counts of each run and the bf16 against float32 PSNR of the
    fake_A PNGs.  Its lines carry `tag`."""
    from cfen_vit_tpu_torch import test as cli
    from cfen_vit_tpu_torch.config import parse_args
    from cfen_vit_tpu_torch.models.dehazing_model import DehazingModel
    from cfen_vit_tpu_torch.models.generator import Generator, init_weights
    from cfen_vit_tpu_torch.ops import cuda_attn, cuda_stem, cuda_tail
    wrappers = {"attention": cuda_attn, "tail": cuda_tail, "stem": cuda_stem}

    paths = write_hazy_pngs(os.path.join(tmp, "data"))
    net = init_weights(Generator(spec), torch.Generator().manual_seed(SEED))
    net = net.cuda().eval()
    first = np.stack([read_png(p) for p in paths[:BATCH]])
    with torch.no_grad():   # data-dependent ActNorm init, all branches
        x = torch.from_numpy(first).cuda().permute(0, 3, 1, 2).contiguous()
        net(x.float() / 127.5 - 1.0)
    ckpt = os.path.join(tmp, "ckpt", "smoke")
    os.makedirs(ckpt)
    torch.save(net.state_dict(), os.path.join(ckpt, "1_net_G.pth"))
    log(tag, f"seeded {spec.name} model, "
        f"{sum(p.numel() for p in net.parameters())} parameters, ActNorms "
        "initialised on batch 0, saved 1_net_G.pth")
    del net

    def argv(dtype):
        return ["--dataroot", os.path.join(tmp, "data"), "--name", "smoke",
                "--checkpoints_dir", os.path.join(tmp, "ckpt"),
                "--results_dir", os.path.join(tmp, f"results_{dtype}"),
                "--model", model_flag, "--dataset_mode", "dec_vit",
                "--model_G", spec.name, "--n_feats", str(spec.n_feats),
                "--hidden_dim_ratio", str(spec.hidden_dim_ratio),
                "--patch_size", str(spec.patch_size),
                "--loadSize", str(spec.load_size), "--sb", "--out_all",
                "--batchSize", str(BATCH), "--gpu_ids", "0",
                "--which_epoch", "1", "--compute_dtype", dtype]

    outputs, launches = {}, {}
    for dtype in ("float32", "bfloat16"):
        for mod in wrappers.values():
            mod.launches = 0
        stats = cli.main(argv(dtype))
        launches[dtype] = {k: m.launches for k, m in wrappers.items()}
        log(tag, f"{dtype} CLI: {stats['images']} images in "
            f"{stats['seconds']:.2f} s, steady "
            f"{stats['steady_img_per_s']:.2f} img/s; kernel launches "
            f"{launches[dtype]}")
        if not all(launches[dtype].values()):
            raise AssertionError(f"{dtype}: a kernel of the path never "
                                 f"launched: {launches[dtype]}")
        pngs = sorted(glob.glob(os.path.join(
            tmp, f"results_{dtype}", "smoke", "test_1", "images",
            "*_fake_A.png")))
        imgs = np.stack([read_png(p) for p in pngs])
        if len(pngs) != N_IMAGES or imgs.shape[1:] != (SIDE, SIDE, 3):
            raise AssertionError(f"{dtype}: expected {N_IMAGES} fake_A "
                                 f"PNGs of {SIDE}x{SIDE}, got "
                                 f"{len(pngs)} of {imgs.shape[1:]}")
        if any(im.min() == im.max() for im in imgs):
            raise AssertionError(f"{dtype}: a fake_A PNG is constant")
        outputs[dtype] = imgs.astype(np.float64)

        model = DehazingModel(parse_args(argv(dtype), is_train=False),
                              torch.device("cuda"))
        model.setup()
        model.set_input({"B": first, "B_paths": paths[:BATCH]})
        model.test()   # warm
        torch.cuda.synchronize()
        t0, reps = time.perf_counter(), 10
        for _ in range(reps):
            model.test()
        log(tag, f"{dtype} model.test() on device-resident weights: "
            f"{reps * BATCH / (time.perf_counter() - t0):.2f} img/s "
            f"(batch {BATCH}, uint8 in/out incl. host copies)")
        if dtype == "float32":
            with ExitStack() as stack:   # same model, plain versions
                for mod, fn, plain in (
                        (cuda_attn, "block_attention", "attention_core"),
                        (cuda_tail, "tail_epilogue", "tail_plain"),
                        (cuda_stem, "fused_stem", "stem_plain")):
                    stack.enter_context(mock.patch.object(
                        mod, fn, getattr(mod, plain)))
                plain_out = model.test()["fake_A"].astype(np.float64)
            diff = np.abs(plain_out - outputs[dtype][:BATCH]).max()
            log(tag, f"float32 fake_A, kernels vs plain path: max "
                f"{diff:.0f}/255 (limit 2/255)")
            if diff > 2:
                raise AssertionError(f"kernel path is {diff}/255 off the "
                                     "plain path")
        del model
    mse = np.mean((outputs["bfloat16"] - outputs["float32"]) ** 2)
    psnr = 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))
    log(tag, f"bfloat16 vs float32 fake_A: PSNR {psnr:.2f} dB "
        "(limit 35 dB)")
    if psnr <= 35.0:
        raise AssertionError(f"bfloat16 PSNR {psnr:.2f} dB <= 35 dB")
    per_image = [10 * np.log10(255.0 ** 2 / max(np.mean((b - f) ** 2), 1e-12))
                 for b, f in zip(outputs["bfloat16"], outputs["float32"])]
    log(tag, f"bfloat16 vs float32 fake_A, mean of per-image PSNR "
        f"{np.mean(per_image):.4f} dB (the eval CLI's statistic)")
    return launches, float(np.mean(per_image))


def _counters():
    from cfen_vit_tpu_torch.ops import cuda_attn, cuda_mrf, cuda_stem, cuda_tail
    return {"attention": (cuda_attn, "launches"), "tail": (cuda_tail, "launches"),
            "stem": (cuda_stem, "launches"), "mrf_fwd": (cuda_mrf, "fwd_launches"),
            "mrf_bwd_do": (cuda_mrf, "do_launches"),
            "mrf_bwd_dt": (cuda_mrf, "dt_launches"),
            "attention recomputes": (cuda_attn, "recomputes"),
            "tail recomputes": (cuda_tail, "recomputes"),
            "stem recomputes": (cuda_stem, "recomputes")}


def phase_train(torch, spec, images=N_IMAGES, full=True, tag="train"):
    """The GAN training step through its CLI, in float32 and bfloat16, over
    2 epochs (--niter 1 --niter_decay 1: the first at half the LR, the
    second at 0) of `images` images at batch 4; returns the launch counts
    of each run.  `full`: the checkpoints are saved and checked, and the
    test CLI reads the trained generator; else nothing is saved (the
    default flags' 662M-parameter generator)."""
    from cfen_vit_tpu_torch import test as test_cli
    from cfen_vit_tpu_torch.config import parse_args
    from cfen_vit_tpu_torch.train.cli import main as train_main
    from cfen_vit_tpu_torch.train.trainer import GanTrainer

    counters = _counters()
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=REPO) as tmp:
        write_hazy_pngs(os.path.join(tmp, "data"), train=True)
        for dtype in ("float32", "bfloat16"):
            ckpt = os.path.join(tmp, f"ckpt_{dtype}")
            argv = ["--dataroot", os.path.join(tmp, "data"), "--name", "train",
                    "--checkpoints_dir", ckpt,
                    "--model", "dec_vit", "--dataset_mode", "dec_vit",
                    "--model_G", spec.name, "--n_feats", str(spec.n_feats),
                    "--hidden_dim_ratio", str(spec.hidden_dim_ratio),
                    "--patch_size", str(spec.patch_size),
                    "--loadSize", str(spec.load_size), "--sb",
                    "--batchSize", str(BATCH), "--niter", "1",
                    "--niter_decay", "1", "--gpu_ids", "0",
                    "--print_freq", str(BATCH), "--compute_dtype", dtype,
                    "--max_dataset_size", str(images)]
            if not full:
                argv += ["--save_epoch_freq", "3"]
            fresh = GanTrainer(parse_args(argv, save_opt=False),
                               torch.device("cuda"))   # the same seeded init
            start = {k: v.clone() for k, v in fresh.g.state_dict().items()}
            start.update({f"D.{k}": v.clone()
                          for k, v in fresh.d.state_dict().items()})
            del fresh
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            for mod, attr in counters.values():
                setattr(mod, attr, 0)
            t0 = time.perf_counter()
            run = train_main(argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches[dtype] = {k: getattr(mod, attr)
                               for k, (mod, attr) in counters.items()}
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            steps = run["step_seconds"]
            log(tag, f"{dtype}: {len(steps)} steps in {seconds:.2f} s "
                f"(run incl. data, checkpoints, LR updates); step seconds "
                f"{[round(x, 4) for x in steps]}; steady "
                f"{statistics.mean(steps[1:]):.4f} s/step after step 0; peak "
                f"device memory {peak:.2f} GiB; launches {launches[dtype]}")
            for i, losses in enumerate(run["losses"]):
                log(tag, f"{dtype} step {i}: " + ", ".join(
                    f"{k} {v:.5g}" for k, v in losses.items()))
            if len(steps) != 2 * images // BATCH:
                raise AssertionError(f"{dtype}: {len(steps)} steps, expected "
                                     f"{2 * images // BATCH}")
            bad = [k for losses in run["losses"] for k, v in losses.items()
                   if not np.isfinite(v)]
            if bad:
                raise AssertionError(f"{dtype}: non-finite losses {bad}")
            model = run["model"]
            if model.step != len(steps):
                raise AssertionError(f"{dtype}: {model.step} steps applied of "
                                     f"{len(steps)} (skip gate)")
            now = dict(model.g.state_dict())
            now.update({f"D.{k}": v for k, v in model.d.state_dict().items()})
            moved = {net: np.mean([not torch.equal(now[k], start[k])
                                   for k in start if k.startswith(net)
                                   and not k.endswith("initialized")])
                     for net in ("D.", "")}
            log(tag, f"{dtype}: share of tensors moved: G and D "
                f"{moved['']:.3f}, D {moved['D.']:.3f}")
            if moved["D."] < 0.99 or moved[""] < 0.99:
                raise AssertionError(f"{dtype}: parameters did not move: {moved}")
            missing = [k for k, v in launches[dtype].items() if not v]
            if missing:
                raise AssertionError(f"{dtype}: never launched or recomputed "
                                     f"on the training path: {missing}")
            if not full:
                del run, model, now, start
                torch.cuda.empty_cache()
                continue
            files = [f"{e}_net_{n}.pth" for e in ("1", "2", "latest")
                     for n in ("G", "D_A", "D_R", "D_S")]
            files += [f"{e}_train_state.pt" for e in ("1", "2", "latest")]
            absent = [f for f in files if not os.path.exists(
                os.path.join(ckpt, "train", f))]
            if absent:
                raise AssertionError(f"{dtype}: checkpoints missing: {absent}")
            del run, model, now
            torch.cuda.empty_cache()

            results = os.path.join(tmp, f"results_{dtype}")
            stats = test_cli.main(argv[:4] + [
                "--checkpoints_dir", ckpt, "--results_dir", results] + argv[6:]
                + ["--out_all", "--which_epoch", "2"])
            pngs = sorted(glob.glob(os.path.join(results, "train", "test_2",
                                                 "images", "*_fake_A.png")))
            imgs = [read_png(p) for p in pngs]
            if len(imgs) != N_IMAGES or any(
                    im.shape != (SIDE, SIDE, 3) or im.min() == im.max()
                    for im in imgs):
                raise AssertionError(f"{dtype}: the trained generator gave "
                                     f"{len(imgs)} fake_A PNGs, expected "
                                     f"{N_IMAGES} non-constant")
            log(tag, f"{dtype}: test CLI read 2_net_G.pth, wrote "
                f"{len(imgs)} fake_A PNGs ({stats['images']} images)")
    return launches


def _post(url: str, body: bytes):
    """One POST /dehaze: (uint8 image, client seconds, X-*-Ms headers)."""
    from PIL import Image
    t0 = time.perf_counter()
    req = urllib.request.Request(f"{url}/dehaze", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        raw, headers = r.read(), dict(r.headers)
    seconds = time.perf_counter() - t0
    with Image.open(io.BytesIO(raw)) as im:
        img = np.asarray(im.convert("RGB"))
    split = {k: float(v) for k, v in headers.items() if k.startswith("X-")}
    return img, seconds, split


def _serve_burst(torch, cfg, model, size, bodies, counters):
    """Serve the bodies twice each from one client thread per body; returns
    the replies (body order, then round), the launch counts, the latency
    stats and /healthz."""
    from http.server import ThreadingHTTPServer
    from cfen_vit_tpu_torch import serve
    stats = serve.Stats()
    handler = serve.make_handler(cfg, model, size, stats, max_batch=BATCH,
                                 window_ms=3.0)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_port}"
    results = [[None, None] for _ in bodies]
    errors = []

    def client(i):
        try:
            for rnd in range(2):
                results[i][rnd] = _post(url, bodies[i])
        except Exception as e:   # surfaced below
            errors.append(repr(e))
    try:
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(len(bodies))]
        for c in clients:
            c.start()
        for c in clients:
            c.join()
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        httpd.shutdown()
        handler.batcher.close()
        server.join(60)
    if errors:
        raise AssertionError(f"requests failed: {errors[:3]}")
    replies = [r for pair in results for r in pair]
    lat = sorted(r[1] * 1e3 for r in replies)
    split = {k: statistics.mean(r[2][k] for r in replies) for k in replies[0][2]}
    return ([r[0] for r in replies], launches,
            {"p50_ms": float(np.percentile(lat, 50)),
             "p90_ms": float(np.percentile(lat, 90)),
             "req_s": len(replies) / wall, "split_ms": split}, health)


def phase_serve(torch, spec, tmp, e2e_psnr):
    """The HTTP server with K2 on (CFEN_PALLAS_VIT=1) on phase 4's
    checkpoint and PNGs under `tmp`, --self_ensemble, --chop and the eval
    CLI; returns the launch counts of each dtype's burst of requests."""
    from cfen_vit_tpu_torch import eval as eval_cli
    from cfen_vit_tpu_torch import serve
    from cfen_vit_tpu_torch.ops import cuda_attn, cuda_stem, cuda_tail, cuda_vit
    counters = {"fused_vit": (cuda_vit, "launches"),
                "attention": (cuda_attn, "launches"),
                "tail": (cuda_tail, "launches"), "stem": (cuda_stem, "launches")}
    paths = sorted(glob.glob(os.path.join(tmp, "data", "hazy", "*.png")))
    bodies = []
    for p in paths:
        with open(p, "rb") as fh:
            bodies.append(fh.read())
    hazy = np.stack([read_png(p) for p in paths])

    def argv(dtype, *extra):
        return ["--name", "smoke", "--checkpoints_dir", os.path.join(tmp, "ckpt"),
                "--dataroot", os.path.join(tmp, "data"), "--which_epoch", "1",
                "--model_G", spec.name, "--n_feats", str(spec.n_feats),
                "--hidden_dim_ratio", str(spec.hidden_dim_ratio),
                "--patch_size", str(spec.patch_size),
                "--loadSize", str(spec.load_size), "--compute_dtype", dtype,
                "--gpu_ids", "0", *extra]

    served, launches = {}, {}
    os.environ["CFEN_PALLAS_VIT"] = "1"
    try:
        for dtype in ("float32", "bfloat16"):
            t0 = time.perf_counter()
            cfg, model, size = serve.build_model(argv(dtype))
            serve.warm(cfg, model, size, BATCH)
            torch.cuda.synchronize()
            log("serve", f"{dtype}: model built and warmed (batch shapes "
                f"{serve._batch_shapes(BATCH)}) in {time.perf_counter() - t0:.2f} s")
            _serve_burst(torch, cfg, model, size, bodies, counters)  # warm-up
            replies, launches[dtype], lat, health = _serve_burst(
                torch, cfg, model, size, bodies, counters)
            log("serve", f"{dtype}: {len(replies)} requests from {len(bodies)} "
                f"clients, after an untimed burst on another server: p50 "
                f"{lat['p50_ms']:.2f} ms, p90 {lat['p90_ms']:.2f} ms, "
                f"{lat['req_s']:.2f} req/s; mean header split (ms) "
                f"{json.dumps({k: round(v, 2) for k, v in lat['split_ms'].items()})}"
                f"; launches {launches[dtype]}; K2 launches per batch "
                f"{launches[dtype]['fused_vit'] / max(health['batches'], 1):.2f}")
            log("serve", f"{dtype} /healthz {json.dumps(health)}")
            if any(im.shape != (SIDE, SIDE, 3) or im.min() == im.max()
                   for im in replies):
                raise AssertionError(f"{dtype}: a reply is not a non-constant "
                                     f"{SIDE}x{SIDE} PNG")
            if not (launches[dtype]["fused_vit"] and launches[dtype]["attention"]):
                raise AssertionError(f"{dtype}: K2 and K1 must both launch while "
                                     f"serving: {launches[dtype]}")
            served[dtype] = np.stack(replies).astype(np.float64)
            model.set_input({"B": hazy[:BATCH], "B_paths": paths[:BATCH]})
            rates = {"1": [], "0": []}
            for k2 in ("1", "0", "0", "1"):     # in turns, on the same card
                os.environ["CFEN_PALLAS_VIT"] = k2
                rates[k2].append(_images_per_s(torch, model))
            os.environ["CFEN_PALLAS_VIT"] = "1"
            log("serve", f"{dtype} model.test() on a resident batch of {BATCH} "
                f"(uint8 in and out, host copies included): K2 on "
                f"{statistics.mean(rates['1']):.2f} img/s, K2 off "
                f"{statistics.mean(rates['0']):.2f} img/s (on, off, off, on: "
                f"{[round(r, 2) for r in rates['1'][:1] + rates['0'] + rates['1'][1:]]})")
            if dtype == "float32":   # the same model with K2 off
                os.environ.pop("CFEN_PALLAS_VIT")
                try:
                    ref = []
                    for i in range(0, len(paths), BATCH):
                        model.set_input({"B": hazy[i:i + BATCH],
                                         "B_paths": paths[i:i + BATCH]})
                        ref.append(model.test()["fake_A"])
                finally:
                    os.environ["CFEN_PALLAS_VIT"] = "1"
                ref = np.repeat(np.concatenate(ref).astype(np.float64), 2, axis=0)
                diff = np.abs(served[dtype] - ref).max()
                log("serve", f"float32 replies (K2 on) vs model.test() with K2 "
                    f"off: max {diff:.0f}/255 (limit 2/255)")
                if diff > 2:
                    raise AssertionError(f"served fake_A {diff}/255 off K2-off")
            del model
            _infer_utils(torch, argv, dtype, hazy)
            torch.cuda.empty_cache()
    finally:
        os.environ.pop("CFEN_PALLAS_VIT", None)
    mse = np.mean((served["bfloat16"] - served["float32"]) ** 2)
    psnr = 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))
    log("serve", f"bfloat16 vs float32 replies: PSNR {psnr:.2f} dB (limit 35 dB)")
    if psnr <= 35.0:
        raise AssertionError(f"served bfloat16 PSNR {psnr:.2f} dB <= 35 dB")

    # the eval CLI on the card over phase 4's fake_A PNGs
    gt = os.path.join(tmp, "gt_float32")
    os.makedirs(gt)
    pred = os.path.join(tmp, "results_bfloat16", "smoke", "test_1", "images")
    for f in glob.glob(os.path.join(tmp, "results_float32", "smoke", "test_1",
                                    "images", "*_fake_A.png")):
        shutil.copy(f, os.path.join(gt, os.path.basename(f).replace("_fake_A", "")))
    out = io.StringIO()
    with redirect_stdout(out):
        rc = eval_cli.main(["--pred", pred, "--gt", gt, "--msssim", "--json",
                            "--gpu_ids", "0"])
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    log("serve", f"eval CLI (bf16 fake_A against float32): {json.dumps(res)}; "
        f"phase 4 gave {e2e_psnr:.4f} dB (limit 0.01 dB apart)")
    if rc != 0 or res["n"] != N_IMAGES or abs(res["psnr"] - e2e_psnr) > 0.01:
        raise AssertionError(f"eval CLI rc {rc}, {res} against {e2e_psnr:.4f} dB")
    return launches


def _images_per_s(torch, model, reps=10):
    """Images per second of model.test() on its resident batch."""
    model.test()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        model.test()
    return reps * model.real_B.shape[0] / (time.perf_counter() - t0)


def _infer_utils(torch, argv, dtype, hazy):
    """--self_ensemble on a batch of 4 and --chop on a 1024x768 image
    through DehazingModel; a 512 input under --chop is the plain forward,
    to 1e-5: two float32 forwards of the same input differ by a few ulps
    on the card (cuDNN's transposed convolutions sum with atomics)."""
    from PIL import Image
    from cfen_vit_tpu_torch.config import parse_args
    from cfen_vit_tpu_torch.models.dehazing_model import DehazingModel
    x = hazy[:BATCH].astype(np.float32) / 127.5 - 1.0
    big = np.asarray(Image.fromarray(hazy[0]).resize((1024, 768), Image.BICUBIC))
    for flag, batch, shape in (
            ("--self_ensemble", x, (BATCH, SIDE, SIDE, 3)),
            ("--chop", big[None].astype(np.float32) / 127.5 - 1.0, (1, 768, 1024, 3))):
        model = DehazingModel(parse_args(argv(dtype, "--out_all", flag),
                                         is_train=False, save_opt=False),
                              torch.device("cuda"))
        model.setup()
        model.set_input({"B": batch, "B_paths": ["x"] * len(batch)})
        t0 = time.perf_counter()
        out = model.test()["fake_A"]
        seconds = time.perf_counter() - t0
        ok = out.shape == shape and out.dtype == np.float32 and np.isfinite(out).all()
        msg = ""
        if flag == "--chop":
            model.set_input({"B": x[:1], "B_paths": ["x"]})
            whole = model.test()["fake_A"]
            with torch.inference_mode():
                plain = model._forward_float(model.real_B)["d"].float().cpu().numpy()
            diff = float(np.abs(whole - plain).max())
            ok &= diff <= 1e-5
            msg = f"; a {SIDE} input vs the plain forward: max diff {diff:.3g}"
        log("serve", f"{dtype} {flag}: fake_A {out.shape} float32 finite in "
            f"{seconds:.2f} s{msg} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{dtype} {flag} failed")
        del model


def _deform_inputs(torch, n, h, w, cin, cout, k, dtype, off_std=2.0, seed=SEED):
    """x, offset (std off_std), mask, w (std 0.05), b on the card, NCHW."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape, std=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * std).to(dtype)
    mask = torch.rand((n, k * k, h, w), generator=g, device="cuda").to(dtype)
    return [rn(n, cin, h, w), rn(n, 2 * k * k, h, w, std=off_std), mask,
            rn(cout, cin, k, k, std=0.05), rn(cout, std=0.1)]


def _torchvision_deform():
    """torchvision.ops.deform_conv2d where torchvision imports (timed only,
    as the library yardstick; the port never calls it), else None."""
    try:
        from torchvision.ops import deform_conv2d
    except ImportError:
        return None
    return deform_conv2d


def phase_deform(torch, results):
    """K6 against deform_plain, the K6 autograd Function's grads, then its
    main path (the Pack and the bench entry point) with the counts reset;
    returns the launch counts of that run per dtype."""
    from cfen_vit_tpu_torch import bench_deform
    from cfen_vit_tpu_torch.bench_cases import device_ms
    from cfen_vit_tpu_torch.ops import cuda_deform
    from cfen_vit_tpu_torch.ops import deform_conv as D
    library = _torchvision_deform()
    log("deform", "torchvision " + ("imports: deform_conv2d is the library time"
                                    if library else "does not import: library none"))
    cases = [(g, 2.0) for g in bench_deform.GEOMETRIES] + [((2, 64, 64, 64, 64, 3), 12.0)]
    failures = []
    with torch.inference_mode():
        for (n, h, w, cin, cout, k), off_std in cases:
            for dtype in (torch.float32, torch.bfloat16):
                dn = str(dtype).split(".")[-1]
                args = _deform_inputs(torch, n, h, w, cin, cout, k, dtype, off_std)
                geo = (1, k // 2, 1)
                got = D.modulated_deform_conv(*args, *geo)
                torch.cuda.synchronize()
                ref = D.deform_plain(*args, *geo)
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs().max().item()
                atol, rtol = TOL[dn]
                ok = bool(torch.allclose(got.float(), ref.float(), atol=atol,
                                         rtol=rtol))
                label = f"{n}x{h}x{w}x{cin}->{cout} k{k}"
                if off_std > 2.0:
                    beyond = (args[1].float().abs() > 12).float().mean().item()
                    log("deform", f"K6 {label} {dn}, offsets std {off_std} "
                        f"({100 * beyond:.1f}% beyond ±12): max_abs_err "
                        f"{err:.3g} (atol {atol}, rtol {rtol}) "
                        f"{'ok' if ok else 'FAIL'}")
                    if not ok or beyond < 0.2:
                        failures.append(f"K6 {label} {dn} offsets beyond 12")
                    continue
                ms = time_ms(torch, lambda: D.modulated_deform_conv(*args, *geo))
                plain_ms = time_ms(torch, lambda: D.deform_plain(*args, *geo), 5, 1)
                lib_ms, lib = None, ""
                if library is not None:
                    x, off, mask, wt, b = args
                    try:
                        lib_ms = time_ms(torch, lambda: library(
                            x, off, wt, b, padding=k // 2, mask=mask))
                        lib = f", library {lib_ms:.4f} ms"
                    except RuntimeError as e:   # e.g. a dtype it does not take
                        lib = f", library refused {dn}: {str(e)[:80]}"
                flops = 2.0 * n * h * w * k * k * cin * cout
                nbytes = (sum(t.numel() for t in args) + ref.numel()) * args[0].element_size()
                bound = bound_ms(flops, nbytes, dn)
                dev = device_ms(lambda: D.modulated_deform_conv(*args, *geo))
                log("deform", f"K6 {label} {dn}: max_abs_err {err:.3g} (atol "
                    f"{atol}, rtol {rtol}) {'ok' if ok else 'FAIL'}; kernel "
                    f"{ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s), device "
                    f"{_ms(dev)} (profiler), plain {plain_ms:.4f} ms{lib}, bound "
                    f"{bound[0]:.4f} ms ({bound[1]})")
                _record(results, "deform", dn, err, ms, plain_ms, bound, lib_ms,
                        device_ms=dev)
                if not ok:
                    failures.append(f"K6 {label} {dn}")
                del args, got, ref
    _log_totals("deform", results, "deform")

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        args = _deform_inputs(torch, 4, 256, 256, 48, 48, 3, dtype, seed=SEED + 3)
        before = (cuda_deform.launches, cuda_deform.recomputes)
        out, grads = _grads(torch, lambda *a: D.modulated_deform_conv(*a, 1, 1, 1), args)
        ref, ref_grads = _grads(torch, lambda *a: D.deform_plain(*a, 1, 1, 1), args)
        torch.cuda.synchronize()
        counts = (cuda_deform.launches - before[0], cuda_deform.recomputes - before[1])
        rel = [((a.float() - b.float()).norm() / b.float().norm()).item()
               for a, b in zip(grads, ref_grads)]
        bar = 1e-4 if dtype == torch.float32 else 1e-2
        ok = (counts == (1, 1) and max(rel) < bar and bool(torch.allclose(
            out.float(), ref.float(), atol=TOL[dn][0], rtol=TOL[dn][1])))
        log("deform", f"K6 autograd 4x256x256x48->48 {dn}: grads of x, offset, "
            f"mask, w, b against autograd of deform_plain, relative norm "
            f"{', '.join(f'{e:.3g}' for e in rel)} (bar {bar}); launches, "
            f"recomputes {counts} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"K6 autograd {dn}")
        del args, out, grads, ref, ref_grads
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"K6 disagrees with deform_plain: {failures}")

    # the main path, counted: the Pack forward and backward, then the bench
    launches = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        pack = D.ModulatedDeformConvPack(48, 48).cuda().to(dtype)
        with torch.no_grad():   # a non-zero offset conv, so offsets vary
            pack.conv_offset_mask.weight.normal_(0.0, 0.05)
            pack.conv_offset_mask.bias.normal_(0.0, 0.5)
        x = _deform_inputs(torch, 2, 96, 96, 48, 48, 3, dtype)[0].requires_grad_()
        cuda_deform.launches = cuda_deform.recomputes = 0
        out = pack(x)
        (out.float() ** 2).sum().backward()
        torch.cuda.synchronize()
        pack_counts = (cuda_deform.launches, cuda_deform.recomputes)
        with torch.no_grad(), mock.patch.object(D, "modulated_deform_conv",
                                                D.deform_plain):
            plain = pack(x)
        grads_ok = all(p.grad is not None and bool(torch.isfinite(p.grad).all())
                       for p in [x, *pack.parameters()])
        ok = (pack_counts == (1, 1) and grads_ok and bool(torch.allclose(
            out.float(), plain.float(), atol=TOL[dn][0], rtol=TOL[dn][1])))
        log("deform", f"ModulatedDeformConvPack(48, 48) on [2,48,96,96] {dn}: "
            f"launches, recomputes per forward and backward {pack_counts}; "
            f"output against the Pack on deform_plain max "
            f"{(out.float() - plain.float()).abs().max().item():.3g}; grads "
            f"finite {grads_ok} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{dn}: the Pack on the card failed")
        del pack, x, out, plain

        out_buf = io.StringIO()
        with redirect_stdout(out_buf):
            rows = bench_deform.main(["--iters", "5", "--dtype", dn,
                                      "--gpu_ids", "0"])
        torch.cuda.synchronize()
        launches[dn] = {"deform": cuda_deform.launches,
                        "deform recomputes": cuda_deform.recomputes}
        for line in out_buf.getvalue().strip().splitlines():
            log("deform", f"bench_deform {line}")
        numbers = [v for r in rows for v in r.values()
                   if isinstance(v, float)]
        cuda_rows = [r for r in rows if r["path"] == "cuda"]
        if (len(rows) != 2 * len(bench_deform.GEOMETRIES)
                or not all(np.isfinite(v) for v in numbers)
                or not all(r["k6_launches"] > 0 for r in cuda_rows)):
            raise AssertionError(f"{dn}: bench_deform lines not finite or K6 "
                                 f"did not launch: {rows}")
        log("deform", f"{dn} main path (Pack, bench_deform): launches "
            f"{launches[dn]}")
        torch.cuda.empty_cache()
    return launches


def phase_defaults(torch, canonical):
    """Phase 8: the JAX package's default flags (n_feats 32,
    hidden_dim_ratio 6, 4 heads: LViT head dim 32, GViT 128, a 16-channel
    stem and tails): K1, K3 and K4 against their plain versions at the
    shapes this geometry gives them, the inference CLI over phase 4's kind
    of 8 PNGs with its gates, then 2 training steps per dtype through the
    train CLI.
    Returns the launch counts of the inference and the training runs."""
    spec = replace(canonical, n_feats=32, hidden_dim_ratio=6)
    shapes = sorted({(v.embedding_dim // v.num_heads, v.seq_length) for v in
                     [spec.lvit_spec(lvl) for lvl in (1, 2, 3)]
                     + [spec.gvit_spec(lvl, encoder=False) for lvl in (1, 2, 3)]})
    log("defaults", f"n_feats {spec.n_feats}, hidden_dim_ratio "
        f"{spec.hidden_dim_ratio}, {spec.num_heads} heads: (head dim, S) "
        f"{shapes}, stem and tails {spec.stem_channels()} channels")
    # K1, K3 and K4 at the shapes this geometry gives them, untimed
    with torch.inference_mode():
        failures = _hold_untimed(torch, [c[:5] for c in kernel_cases(torch, spec)])
    if failures:
        raise AssertionError(f"kernels disagree with plain at the defaults: "
                             f"{failures}")
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=REPO)
    try:
        infer, _ = phase_e2e(torch, spec, work, tag="defaults")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    train = phase_train(torch, spec, images=BATCH, full=False, tag="defaults")
    return infer, train


VARIANT_BATCH, VARIANT_REPS = 2, 3
# a spec whose bf16 fake_A misses 35 dB against float32 passes only where
# its plain path in bf16 misses too, and the kernels lose at most this
# many dB beside it: the spec's own bf16 arithmetic, logged as a finding
BF16_PLAIN_DB = 1.0


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0 ** 2 / max(mse, 1e-12)))


def _variant(torch, name, first, tmp, wrappers):
    """One spec at full width (n_feats 24, hidden_dim_ratio 4, patch 32, 4
    heads; loadSize 256 half-res, 512 full-res, so a 512x512 input) at
    batch 2: seeded weights, ActNorms initialised on the batch, saved and
    loaded through setup(); then model.test() in float32 (all outputs,
    counted and timed, then the same model on the plain versions),
    bfloat16 (timed) and float32 --out_all.  Returns its row, the gates it
    missed, and a finding (a bf16 miss its plain path shares) or None."""
    from cfen_vit_tpu_torch.config import parse_args
    from cfen_vit_tpu_torch.models.dehazing_model import (_MODEL_DEFAULT_G,
                                                          DehazingModel)
    from cfen_vit_tpu_torch.models.generator import init_weights
    from cfen_vit_tpu_torch.models.registry import generator_spec
    from cfen_vit_tpu_torch.ops import cuda_attn, cuda_stem, cuda_tail
    load = 256 if generator_spec(name).half_res_trunk else 512
    # the spec's own --model where one picks it, else dec_vit and --model_G
    model_flag = {g: m for m, g in _MODEL_DEFAULT_G.items() if g}.get(
        name, "dec_vit")
    argv = ["--name", name, "--checkpoints_dir", tmp, "--dataroot", tmp,
            "--model", model_flag, "--model_G", name,
            "--n_feats", "24", "--hidden_dim_ratio", "4", "--patch_size", "32",
            "--num_heads", "4", "--loadSize", str(load), "--gpu_ids", "0",
            "--which_epoch", "1"]

    def model_for(*extra, build_on="cuda"):
        """The wrapper these flags build; its generator is allocated (and
        drawn by torch's default init) on `build_on`."""
        cfg = parse_args(argv + list(extra), is_train=False, save_opt=False)
        with torch.device(build_on):
            return cfg, DehazingModel(cfg, torch.device("cuda"))

    # the seeded draw comes from a CPU generator, so this one is built there
    cfg, model = model_for(build_on="cpu")
    if model.spec.name != name or cfg.input_size() != SIDE:
        raise AssertionError(f"{name}: --model {cfg.model} built "
                             f"{model.spec.name} for {cfg.input_size()} px")
    net = init_weights(model.net, torch.Generator().manual_seed(SEED))
    net = net.cuda().eval()
    with torch.no_grad():   # the ActNorm init pass, every output
        x = torch.from_numpy(first).cuda().permute(0, 3, 1, 2).contiguous()
        net(x.float() / 127.5 - 1.0)
    os.makedirs(os.path.join(tmp, name), exist_ok=True)
    torch.save(net.state_dict(), os.path.join(tmp, name, "1_net_G.pth"))
    row = {"parameters": sum(p.numel() for p in net.parameters())}
    del net, model
    missed, vis, launches, models = [], {}, {}, {}
    batch = {"B": first, "B_paths": [f"im{i}" for i in range(len(first))]}

    def plain_test(model):
        """model.test() with K1, K3 and K4 swapped for their plain versions."""
        with ExitStack() as stack:
            for mod, fn, plain in (
                    (cuda_attn, "block_attention", "attention_core"),
                    (cuda_tail, "tail_epilogue", "tail_plain"),
                    (cuda_stem, "fused_stem", "stem_plain")):
                stack.enter_context(mock.patch.object(
                    mod, fn, getattr(mod, plain)))
            return model.test()

    for dtype in ("float32", "bfloat16"):
        _, model = models[dtype] = model_for("--compute_dtype", dtype)
        model.setup()
        model.set_input(batch)
        for mod in wrappers.values():
            mod.launches = 0
        vis[dtype] = model.test()
        torch.cuda.synchronize()
        launches[dtype] = {k: m.launches for k, m in wrappers.items()}
        t0 = time.perf_counter()
        for _ in range(VARIANT_REPS):
            model.test()
        torch.cuda.synchronize()
        row[f"ms_{dtype}"] = (time.perf_counter() - t0) * 1e3 / VARIANT_REPS
    plain32 = plain_test(models["float32"][1])
    row["plain_diff"] = {
        k: int(np.abs(v.astype(np.int16) - plain32[k].astype(np.int16)).max())
        for k, v in vis["float32"].items() if k != "real_B"}
    # --out_all: the wrapper that flag builds, on the float32 weights
    _, out_all = model_for("--out_all")
    out_all.net = models["float32"][1].net
    out_all.set_input(batch)
    vis["out_all"] = out_all.test()
    row["launches"] = launches
    row["out_all_diff"] = int(np.abs(
        vis["out_all"]["fake_A"].astype(np.int16)
        - vis["float32"]["fake_A"].astype(np.int16)).max())
    row["psnr_bf16"] = _psnr(vis["bfloat16"]["fake_A"], vis["float32"]["fake_A"])
    finding = None
    if row["psnr_bf16"] <= 35.0:
        # below the limit: is it the kernels, or the spec's own bf16
        # arithmetic (the plain path in bf16 against float32)?
        row["psnr_bf16_plain"] = _psnr(plain_test(models["bfloat16"][1])["fake_A"],
                                       plain32["fake_A"])
        if (row["psnr_bf16_plain"] <= 35.0
                and row["psnr_bf16"] >= row["psnr_bf16_plain"] - BF16_PLAIN_DB):
            finding = (f"bf16 fake_A {row['psnr_bf16']:.2f} dB <= 35, the "
                       f"plain path in bf16 {row['psnr_bf16_plain']:.2f} dB")
        else:
            missed.append(f"bf16 fake_A {row['psnr_bf16']:.2f} dB <= 35, the "
                          f"plain path in bf16 {row['psnr_bf16_plain']:.2f} dB")
    del models, out_all
    torch.cuda.empty_cache()
    # iid_cnn_crs has no ViT, so no attention
    want = {"tail", "stem"} | (set() if generator_spec(name).cnn
                               else {"attention"})
    for dtype in ("float32", "bfloat16"):
        idle = sorted(k for k in want if not launches[dtype][k])
        if idle:
            missed.append(f"{dtype}: {idle} never launched")
    if max(row["plain_diff"].values()) > 2:
        missed.append(f"float32 vs plain {row['plain_diff']} > 2/255")
    if row["out_all_diff"] > 1:
        missed.append(f"--out_all fake_A {row['out_all_diff']}/255 off > 1")
    for key, v in vis.items():
        for visual, arr in v.items():
            if visual != "real_B" and any(im.min() == im.max() for im in arr):
                missed.append(f"{key} {visual} has a constant image")
    return row, missed, finding


def phase_variants(torch):
    """Phase 9: the 17 --model_G specs beside v3 (each through
    `_variant`), then the inference CLI end to end (phase 4's gates) for
    the full-res iid_hlgvit_crs_gd4_cfs and for --model dec_mgvit
    (dec_ipt: no D branch, fake_A is the refined output, no d-only).
    Returns the CLI runs' launch counts."""
    from cfen_vit_tpu_torch.models.registry import _REGISTRY, generator_spec
    from cfen_vit_tpu_torch.ops import cuda_attn, cuda_stem, cuda_tail
    wrappers = {"attention": cuda_attn, "tail": cuda_tail, "stem": cuda_stem}
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=REPO)
    rows, failures = {}, {}
    try:
        paths = write_hazy_pngs(os.path.join(work, "data"))
        first = np.stack([read_png(p) for p in paths[:VARIANT_BATCH]])
        for name in sorted(_REGISTRY):
            if name == "iid_hlgvit_crs_gd4_cfs_v3":
                continue
            rows[name], missed, finding = _variant(torch, name, first, work,
                                                   wrappers)
            r = rows[name]
            log("variants", f"{name}: {r['parameters']} parameters, "
                f"model.test() {r['ms_float32']:.2f} / {r['ms_bfloat16']:.2f}"
                f" ms fp32 / bf16 at batch {VARIANT_BATCH}, launches "
                f"{r['launches']['float32']}, vs plain {r['plain_diff']}/255,"
                f" --out_all {r['out_all_diff']}/255, bf16 "
                f"{r['psnr_bf16']:.2f} dB {'ok' if not missed else missed}")
            if finding:
                log("variants", f"{name}: finding, not a fault of the "
                    f"kernels: {finding} (ROADMAP Queue C)")
            if missed:
                failures[name] = missed
        print(json.dumps({"variants": rows}), flush=True)
        log("variants", f"{len(rows)} specs in {time.perf_counter() - t0:.1f} s")
        cli = {}
        for model, name in (("dec_vit", "iid_hlgvit_crs_gd4_cfs"),
                            ("dec_mgvit", "dec_ipt")):
            spec = replace(generator_spec(name), n_feats=24,
                           hidden_dim_ratio=4, patch_size=32, load_size=512)
            sub = tempfile.mkdtemp(prefix="e2e_", dir=work)
            cli[name], _ = phase_e2e(torch, spec, sub, tag=f"variants {name}",
                                     model_flag=model)
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log("variants", f"phase 9 in {time.perf_counter() - t0:.1f} s")
    if failures:
        raise AssertionError(f"specs that missed a gate: {failures}")
    return cli


# phase 10: the trainers.  The JAX trainer's loss keys of each --model
# (cfen_vit_tpu/train/trainer.py _g_loss and _d_loss)
_DEC_TERMS = ("GAN", "vgg", "gradient_fake", "L2", "ssim")
TRAINER_LOSS_KEYS = {
    "decr_vit": {f"{t}_{b}" for t in _DEC_TERMS for b in "ar"}
    | {"p", "s", "G", "DA", "DR"},
    "decs_vit": {f"{t}_{b}" for t in _DEC_TERMS for b in "as"}
    | {"p", "s", "G", "DA", "DS"},
    "decn_vit": {f"{t}_a" for t in _DEC_TERMS} | {"p", "s", "G", "DA"},
    "vit": {"GAN", "vgg", "gradient_fake_A", "L1", "G", "DA"},
    "dec_mgvit": {f"{t}_{b}" for t in _DEC_TERMS[:4] for b in "ars"}
    | {"G", "DA", "DR", "DS"},
    "dec_vit": {f"{t}_{b}" for t in _DEC_TERMS for b in "ars"}
    | {"p", "s", "G", "DA", "DR", "DS"},
}
MRF_COUNTERS = ("mrf_fwd", "mrf_bwd_do", "mrf_bwd_dt")
# kernels against plain, one step in float32 from the same weights, with
# cuDNN's deterministic algorithms (its default ones differ from run to
# run by about as much as the kernels differ from plain): each loss term
# (relative); the grads of G and of each D as ||g - p|| / ||p|| over the
# network (which bounds the G grad-norm gap from above) and per tensor,
# each within TRAINER_TENSOR_TOL of its own norm plus TRAINER_TENSOR_FLOOR
# of the network's root-mean-square tensor norm (the floor is for tensors
# whose exact grad is zero, such as the biases before an InstanceNorm,
# which hold only float noise).  The readings repeat from run to run but
# for a discrete event in decr_vit's grads in one run of three (G 5.3e-3,
# one tensor 4.1e-2; PERF.md section 6); the limits stand about 2x above
# it, and a wiring fault (a sign, a missing or misrouted grad) moves a
# tensor by its whole norm
TRAINER_LOSS_TOL, TRAINER_G_TOL, TRAINER_D_TOL = 1e-3, 1e-2, 5e-4
TRAINER_TENSOR_TOL, TRAINER_TENSOR_FLOOR = 1e-1, 1e-3
# --grad_accum 2 against accum 1: the mean-normalised terms (JAX's bar,
# tests/test_train.py test_grad_accumulation) and p against half of it
ACCUM_TOL = 5e-3


def _plain_versions(torch):
    """K1, K3, K4 and K5 swapped for their plain versions (a context)."""
    from cfen_vit_tpu_torch.ops import cuda_attn, cuda_mrf, cuda_stem, cuda_tail
    stack = ExitStack()
    for mod, fn, plain in ((cuda_attn, "block_attention", "attention_core"),
                           (cuda_tail, "tail_epilogue", "tail_plain"),
                           (cuda_stem, "fused_stem", "stem_plain"),
                           (cuda_mrf, "mrf_core", "mrf_core_plain")):
        stack.enter_context(mock.patch.object(mod, fn, getattr(mod, plain)))
    return stack


def _step_losses_and_grads(torch, tr, batch):
    """One micro-step of `tr` (float32) on `batch`: its losses and the
    grads of G and of the Ds (float64 copies, keyed by network); the
    trainer's grads are dropped after."""
    for net in (tr.g, tr.d):
        net.zero_grad(set_to_none=True)
    losses, _ = tr._micro_step(tr.g, batch, None)
    grads = {"G": {k: p.grad.double() for k, p in tr.g.named_parameters()
                   if p.grad is not None}}
    for name, d in tr.d.items():
        grads[f"D_{name}"] = {k: p.grad.double() for k, p in d.named_parameters()
                              if p.grad is not None}
    for net in (tr.g, tr.d):
        net.zero_grad(set_to_none=True)
    return {k: float(v) for k, v in losses.items()}, grads


def _grad_errors(got, want):
    """Per network of `want`: ||got - want|| / ||want|| over the network,
    and its worst tensor by (||g_t - p_t|| - floor) / ||p_t|| with the
    floor TRAINER_TENSOR_FLOOR x the root-mean-square tensor norm; the
    worst tensor's name and relative error, and `inside`: the network
    within TRAINER_G_TOL (G) or TRAINER_D_TOL (a D) and every tensor
    within TRAINER_TENSOR_TOL of its norm plus the floor."""
    out = {}
    for net, ref in want.items():
        if set(got[net]) != set(ref):
            raise AssertionError(f"{net}: grads of {sorted(set(got[net]) ^ set(ref))[:4]}"
                                 " on one path only")
        err = {k: float((got[net][k] - p).norm()) for k, p in ref.items()}
        norm = {k: float(p.norm()) for k, p in ref.items()}
        total = math.sqrt(sum(n * n for n in norm.values()))
        floor = TRAINER_TENSOR_FLOOR * total / math.sqrt(len(ref))
        worst = max(ref, key=lambda k: (err[k] - floor) / max(norm[k], 1e-300))
        relative = math.sqrt(sum(e * e for e in err.values())) / total
        limit = TRAINER_G_TOL if net == "G" else TRAINER_D_TOL
        out[net] = {"relative": relative, "worst_tensor": worst,
                    "worst_relative": err[worst] / max(norm[worst], 1e-300),
                    "inside": relative <= limit and err[worst]
                    <= TRAINER_TENSOR_TOL * norm[worst] + floor}
    return out


def _kernels_vs_plain(torch, tr, start, tag):
    """The float32 step on a resident batch with the kernels and on the
    plain versions, from the seeded weights the CLI run started from
    (`start`, the ActNorms initialised on that batch, so that the readings
    repeat from run to run), on cuDNN's deterministic algorithms: each
    loss term within TRAINER_LOSS_TOL relative, the grads of G within
    TRAINER_G_TOL and of each D within TRAINER_D_TOL over the network, and
    every tensor inside its bar (`_grad_errors`).  The kernels' step on cuDNN's default algorithms,
    held against the deterministic one, is logged: the spread the
    deterministic algorithms remove.  Returns the largest loss difference,
    the grad errors and that spread."""
    tr.g.load_state_dict({k: v for k, v in start.items() if not k.startswith("D.")})
    tr.d.load_state_dict({k[2:]: v for k, v in start.items() if k.startswith("D.")})
    batch = _resident(torch, tr)
    tr._init_state(batch["B"])
    _, default = _step_losses_and_grads(torch, tr, batch)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        got, ggrads = _step_losses_and_grads(torch, tr, batch)
        with _plain_versions(torch):
            want, pgrads = _step_losses_and_grads(torch, tr, batch)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    loss_err = max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-12)
                   for k in want)
    grads = _grad_errors(ggrads, pgrads)
    spread = {net: g["relative"] for net, g in _grad_errors(default, ggrads).items()}
    del ggrads, pgrads, default
    log("trainers", f"{tag}: kernels vs plain, one float32 step: largest "
        f"loss term {loss_err:.3g} relative (limit {TRAINER_LOSS_TOL}); "
        "grads, ||g - p|| / ||p|| over the network (limit G "
        f"{TRAINER_G_TOL}, D {TRAINER_D_TOL}) and the worst tensor (limit "
        f"{TRAINER_TENSOR_TOL} + a floor of {TRAINER_TENSOR_FLOOR} x the "
        "network's rms tensor norm): " + "; ".join(
            f"{net} {g['relative']:.3g}, {g['worst_tensor']} "
            f"{g['worst_relative']:.3g}" for net, g in grads.items())
        + "; the kernels' step on cuDNN's default algorithms against it: "
        + ", ".join(f"{net} {v:.3g}" for net, v in spread.items()))
    bad = [net for net, g in grads.items() if not g["inside"]]
    if loss_err > TRAINER_LOSS_TOL or bad:
        raise AssertionError(f"{tag}: kernels vs plain, loss {loss_err}, "
                             f"grads {grads}")
    return {"loss": loss_err, "grads": grads, "default_algorithms": spread}


def _resident(torch, tr, n=BATCH):
    """A seeded synthetic batch (train/overfit.py's set) on the device."""
    from cfen_vit_tpu_torch.train.overfit import make_overfit_set
    from cfen_vit_tpu_torch.train.trainer import device_batch
    return device_batch(make_overfit_set(n, SIDE), tr.device)


def _trainer_cli_run(torch, argv, tag, model):
    """One train CLI run of 2 steps (2 epochs of one batch); returns its
    row (s/step after step 0, peak GiB, launches), the run, the trainer
    and the seeded weights it started from (G's, and D's under "D.").
    Gates: 2 steps applied, finite losses, the JAX loss keys, every G and
    D tensor moved but the generator's unreached modules, which stay; K1,
    K3 and K4 launched and recomputed, and K5's three kernels launched
    exactly where the loss set has ID-MRF."""
    from cfen_vit_tpu_torch.models.generator import unreached_modules
    from cfen_vit_tpu_torch.train import trainer as T
    from cfen_vit_tpu_torch.train.cli import main as train_main

    counters = _counters()
    start = {}
    setup = T.GanTrainer.setup

    def snapshot(self, cfg=None):   # the seeded weights the CLI starts from
        start.update({k: v.detach().clone() for k, v in self.g.state_dict().items()})
        start.update({f"D.{k}": v.detach().clone()
                      for k, v in self.d.state_dict().items()})
        return setup(self, cfg)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    t0 = time.perf_counter()
    with mock.patch.object(T.GanTrainer, "setup", snapshot):
        run = train_main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
    tr = run["model"]
    steps = run["step_seconds"]
    row = {"s_per_step": steps[1] if len(steps) > 1 else None,
           "step_seconds": [round(x, 4) for x in steps],
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": launches, "run_seconds": seconds,
           "parameters": sum(p.numel() for p in tr.g.parameters())}
    log("trainers", f"{tag}: {tr.spec.name}, {row['parameters']} G "
        f"parameters, {len(steps)} steps in {seconds:.2f} s (run incl. data, "
        f"init, checkpoints); step seconds {row['step_seconds']}, "
        f"{row['s_per_step']:.4f} s/step after step 0; peak "
        f"{row['peak_gib']:.2f} GiB; launches {launches}")
    for i, losses in enumerate(run["losses"]):
        log("trainers", f"{tag} step {i}: " + ", ".join(
            f"{k} {v:.5g}" for k, v in losses.items()))
    if len(steps) != 2 or tr.step != 2:
        raise AssertionError(f"{tag}: {len(steps)} steps printed, {tr.step} "
                             "applied, expected 2")
    bad = [k for losses in run["losses"] for k, v in losses.items()
           if not np.isfinite(v)]
    if bad:
        raise AssertionError(f"{tag}: non-finite losses {bad}")
    keys = set(run["losses"][-1])
    if keys != TRAINER_LOSS_KEYS[model]:
        raise AssertionError(f"{tag}: loss keys {sorted(keys)}, the JAX "
                             f"trainer's {sorted(TRAINER_LOSS_KEYS[model])}")
    now = dict(tr.g.state_dict())
    now.update({f"D.{k}": v for k, v in tr.d.state_dict().items()})
    keys = [k for k in start if not k.endswith("initialized")]
    still = {k for k in keys if torch.equal(now[k], start[k])}
    dead = {k for k in keys if k.split(".")[0] in unreached_modules(tr.spec)}
    if still != dead:
        raise AssertionError(f"{tag}: tensors that did not move "
                             f"{sorted(still - dead)[:8]}, unreached ones that "
                             f"moved {sorted(dead - still)[:8]}")
    log("trainers", f"{tag}: every G and D tensor moved but the "
        f"{len(dead)} of modules no loss reaches")
    want_mrf = "p" in TRAINER_LOSS_KEYS[model]
    idle = [k for k in ("attention", "tail", "stem", "attention recomputes",
                        "tail recomputes", "stem recomputes")
            + (MRF_COUNTERS if want_mrf else ()) if not launches[k]]
    stray = [] if want_mrf else [k for k in MRF_COUNTERS if launches[k]]
    if idle or stray:
        raise AssertionError(f"{tag}: never launched {idle}; K5 launched "
                             f"without ID-MRF in the loss set {stray}")
    return row, run, tr, start


def _accum_check(torch, spec, tmp):
    """--grad_accum 2 on the canonical v3 at batch 4 (float32, resident
    batch) against accum 1 from the same weights: the pools take 4 images
    a step, the mean-normalised terms agree, p is halved, and the peak
    memory of the step is lower."""
    from cfen_vit_tpu_torch.config import parse_args
    from cfen_vit_tpu_torch.train.trainer import GanTrainer
    argv = ["--name", "accum", "--checkpoints_dir", tmp,
            "--model_G", spec.name, "--n_feats", str(spec.n_feats),
            "--hidden_dim_ratio", str(spec.hidden_dim_ratio),
            "--patch_size", str(spec.patch_size),
            "--loadSize", str(spec.load_size), "--batchSize", str(BATCH),
            "--gpu_ids", "0", "--grad_accum", "2"]
    tr = GanTrainer(parse_args(argv, save_opt=False), torch.device("cuda"))
    tr._batch = _resident(torch, tr)
    tr._init_state(tr._batch["B"])
    start = {k: v.clone() for k, v in tr.g.state_dict().items()}
    start_d = {k: v.clone() for k, v in tr.d.state_dict().items()}
    out = {}
    for accum in (1, 2, 1):
        tr.g.load_state_dict(start)
        tr.d.load_state_dict(start_d)
        for opt in (tr.g_opt, tr.d_opt):
            opt.state.clear()
        for pool in tr.pools.values():
            pool["n"] = 0
        tr.accum = accum
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr.optimize_parameters()
        losses = tr.get_current_losses()
        torch.cuda.synchronize()
        out[accum] = {"losses": losses, "seconds": time.perf_counter() - t0,
                      "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                      "pools": {k: p["n"] for k, p in tr.pools.items()}}
    one, two = out[1], out[2]
    errs = {k: abs(two["losses"][k] - one["losses"][k]) / max(1.0, abs(one["losses"][k]))
            for k in ("L2_a", "ssim_a", "GAN_a", "vgg_a")}
    errs["p"] = abs(two["losses"]["p"] - one["losses"]["p"] / 2) / abs(one["losses"]["p"] / 2)
    log("trainers", f"--grad_accum 2 vs 1 (v3, batch {BATCH}, float32): "
        f"pools {two['pools']}; relative differences {errs} (limit "
        f"{ACCUM_TOL}; p against half of accum 1's); step {two['seconds']:.4f}"
        f" vs {one['seconds']:.4f} s, peak {two['peak_gib']:.2f} vs "
        f"{one['peak_gib']:.2f} GiB")
    if any(n != BATCH for n in two["pools"].values()):
        raise AssertionError(f"--grad_accum 2: pools {two['pools']}")
    if max(errs.values()) > ACCUM_TOL:
        raise AssertionError(f"--grad_accum 2 vs 1: {errs}")
    if two["peak_gib"] >= one["peak_gib"]:
        raise AssertionError(f"--grad_accum 2 peak {two['peak_gib']:.2f} GiB "
                             f">= accum 1's {one['peak_gib']:.2f}")
    del tr
    return {"accum2": {k: v for k, v in two.items() if k != "losses"},
            "accum1": {k: v for k, v in one.items() if k != "losses"},
            "differences": errs}


def _epdn_check(torch, tmp):
    """EpdnTrainer: 2 steps at 512x512, batch 4, float32 on a resident
    batch: finite losses, the parameters moved."""
    from cfen_vit_tpu_torch.config import parse_args
    from cfen_vit_tpu_torch.train.pix2pixhd import EpdnTrainer
    cfg = parse_args(["--name", "epdn", "--checkpoints_dir", tmp,
                      "--batchSize", str(BATCH), "--gpu_ids", "0"],
                     save_opt=False)
    tr = EpdnTrainer(cfg, torch.device("cuda"))
    start = {k: v.clone() for net in (tr.g, tr.d)
             for k, v in net.state_dict(prefix=f"{type(net).__name__}.").items()}
    from cfen_vit_tpu_torch.train.overfit import make_overfit_set
    batch = make_overfit_set(BATCH, SIDE)
    torch.cuda.reset_peak_memory_stats()
    seconds, losses = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        tr.set_input(batch)
        tr.optimize_parameters()
        losses.append(tr.get_current_losses())
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    now = {k: v for net in (tr.g, tr.d)
           for k, v in net.state_dict(prefix=f"{type(net).__name__}.").items()}
    moved = np.mean([not torch.equal(now[k], start[k]) for k in start])
    row = {"s_per_step": seconds[1], "step_seconds": seconds,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "moved": float(moved),
           "parameters": sum(p.numel() for p in tr.g.parameters())}
    log("trainers", f"EpdnTrainer (LocalEnhancer ngf {cfg.epdn_ngf}, "
        f"{row['parameters']} G parameters, {cfg.num_D}-scale D, batch "
        f"{BATCH}, {SIDE}x{SIDE}, float32): step seconds "
        f"{[round(x, 4) for x in seconds]}, peak {row['peak_gib']:.2f} GiB, "
        f"share of tensors moved {moved:.3f}; losses {losses}")
    if any(not np.isfinite(v) for step in losses for v in step.values()):
        raise AssertionError(f"EpdnTrainer: non-finite losses {losses}")
    if moved < 0.99:
        raise AssertionError(f"EpdnTrainer: parameters did not move ({moved})")
    return row


def phase_trainers(torch):
    """Phase 10: every trainer of the JAX package on the card at full width
    (n_feats 24, hidden_dim_ratio 4, patch 32, 4 heads, a 512x512 input,
    batch 4, --remat --remat_mode branch): --model decr_vit, decs_vit,
    decn_vit, vit and dec_mgvit through the train CLI in float32 and
    bfloat16 (2 steps each, the float32 run saving checkpoints that the
    test CLI reads back), each model's float32 step with the kernels
    against the plain versions, dec_vit on the non-v3
    iid_hlgvit_crs_gd4_cfs, --grad_accum 2, and the EpdnTrainer.  Returns
    the launches of the CLI runs per dtype."""
    from cfen_vit_tpu_torch import test as test_cli
    from cfen_vit_tpu_torch.models.dehazing_model import _MODEL_DEFAULT_G
    from cfen_vit_tpu_torch.models.registry import generator_spec
    t0 = time.perf_counter()
    rows, launches = {}, {"float32": defaultdict(int), "bfloat16": defaultdict(int)}
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=REPO)
    try:
        write_hazy_pngs(os.path.join(work, "data"), train=True)
        runs = [(m, _MODEL_DEFAULT_G[m]) for m in
                ("decr_vit", "decs_vit", "decn_vit", "vit", "dec_mgvit")]
        runs.append(("dec_vit", "iid_hlgvit_crs_gd4_cfs"))
        for model, g_name in runs:
            load = 256 if generator_spec(g_name).half_res_trunk else SIDE
            for dtype in ("float32", "bfloat16"):
                if model == "dec_vit" and dtype == "bfloat16":
                    continue
                tag = f"{model} {dtype}"
                ckpt = os.path.join(work, f"ckpt_{model}_{dtype}")
                save = dtype == "float32" and model != "dec_vit"
                argv = ["--dataroot", os.path.join(work, "data"),
                        "--name", "train", "--checkpoints_dir", ckpt,
                        "--model", model, "--model_G", g_name,
                        "--dataset_mode", "vit" if model == "vit" else "dec_vit",
                        "--n_feats", "24", "--hidden_dim_ratio", "4",
                        "--patch_size", "32", "--num_heads", "4",
                        "--loadSize", str(load), "--sb",
                        "--batchSize", str(BATCH), "--niter", "1",
                        "--niter_decay", "1", "--gpu_ids", "0",
                        "--print_freq", str(BATCH), "--compute_dtype", dtype,
                        "--max_dataset_size", str(BATCH),
                        "--remat", "--remat_mode", "branch",
                        "--save_epoch_freq", "2" if save else "3",
                        "--save_latest_freq", "100000"]
                row, run, tr, start = _trainer_cli_run(torch, argv, tag, model)
                for k, v in row["launches"].items():
                    launches[dtype][k] += v
                if dtype == "float32":
                    row["kernels_vs_plain"] = _kernels_vs_plain(
                        torch, tr, start, tag)
                rows[tag] = row
                del run, tr, start
                torch.cuda.empty_cache()
                if not save:
                    continue
                absent = [f for f in ("2_net_G.pth", "latest_net_G.pth",
                                      "2_train_state.pt")
                          if not os.path.exists(os.path.join(ckpt, "train", f))]
                if absent:
                    raise AssertionError(f"{tag}: checkpoints missing {absent}")
                results = os.path.join(work, f"results_{model}")
                stats = test_cli.main(argv[:4] + [
                    "--checkpoints_dir", ckpt, "--results_dir", results]
                    + argv[6:] + ["--out_all", "--which_epoch", "2"])
                pngs = sorted(glob.glob(os.path.join(
                    results, "train", "test_2", "images", "*_fake_A.png")))
                imgs = [read_png(p) for p in pngs]
                if len(imgs) != BATCH or any(   # --max_dataset_size
                        im.shape != (SIDE, SIDE, 3) or im.min() == im.max()
                        for im in imgs):
                    raise AssertionError(f"{tag}: the trained generator gave "
                                         f"{len(imgs)} fake_A PNGs, expected "
                                         f"{BATCH} non-constant")
                log("trainers", f"{tag}: test CLI read 2_net_G.pth, wrote "
                    f"{len(imgs)} fake_A PNGs ({stats['images']} images)")
                shutil.rmtree(ckpt, ignore_errors=True)
        canonical = replace(generator_spec("iid_hlgvit_crs_gd4_cfs_v3"),
                            n_feats=24, hidden_dim_ratio=4, patch_size=32,
                            load_size=256)
        rows["grad_accum 2"] = _accum_check(torch, canonical, work)
        torch.cuda.empty_cache()
        rows["epdn"] = _epdn_check(torch, work)
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"trainers": rows}, default=float), flush=True)
    log("trainers", f"phase 10 in {time.perf_counter() - t0:.1f} s")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from cfen_vit_tpu_torch.config import set_precision
    from cfen_vit_tpu_torch.models.registry import generator_spec

    t_start = time.perf_counter()
    spec = replace(generator_spec("iid_hlgvit_crs_gd4_cfs_v3"), n_feats=24,
                   hidden_dim_ratio=4, patch_size=32, load_size=256)
    set_precision("highest")   # float32 plain versions without TF32
    os.environ.pop("CFEN_PALLAS_VIT", None)   # K2 off until the serve phase
    phase_env(torch)
    phase_build()
    results = {}
    phase_kernels(torch, spec, results)
    phase_fused_vit(torch, spec, results)
    phase_mrf_kernels(torch, results)
    phase_autograd(torch, spec)
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=REPO)
    try:
        infer_launches, e2e_psnr = phase_e2e(torch, spec, work)
        train_launches = phase_train(torch, spec)
        serve_launches = phase_serve(torch, spec, work, e2e_psnr)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    deform_launches = phase_deform(torch, results)
    default_infer, default_train = phase_defaults(torch, spec)
    variant_cli = phase_variants(torch)
    trainer_launches = phase_trainers(torch)
    ported = [m for m in sys.modules
              if m == "jax" or m.startswith("jax.") or m == "cfen_vit_tpu"
              or m.startswith("cfen_vit_tpu.")]
    if ported:
        raise AssertionError(f"the port imported {sorted(ported)[:5]}")

    entries = []
    for (kernel, dtype), r in results.items():
        source, replaces = KERNELS[kernel]
        # K2's main path is serving, K6's the Pack and bench_deform; every
        # other kernel's is training
        main_path = {"fused_vit": serve_launches,
                     "deform": deform_launches}.get(kernel, train_launches)
        entries.append({"name": f"{kernel} {dtype}", "route": "cuda",
                        "source": source, "replaces": replaces,
                        "launches": main_path[dtype][kernel],
                        "launches_inference": infer_launches[dtype].get(kernel, 0),
                        "launches_serve": serve_launches[dtype].get(kernel, 0),
                        "launches_defaults": (default_train[dtype].get(kernel, 0)
                                              + default_infer[dtype].get(kernel, 0)),
                        "launches_variants_cli": sum(
                            run[dtype].get(kernel, 0) for run in variant_cli.values()),
                        "launches_trainers": trainer_launches[dtype].get(kernel, 0),
                        **r})
    log("done", f"every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
