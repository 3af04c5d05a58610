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
     CUDA-event times, the card's bound; K1 also beside
     F.scaled_dot_product_attention, K2 beside the unfused token path it
     replaces); then MrfCore against the dense mrf_core_plain on value and
     both grads, and the K1, K2, K3 and K4 autograd Functions' grads
     against the plain versions' autograd;
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
     4's mean per-image bf16-vs-float32 PSNR within 0.01 dB.

Phases 1-5 run with K2 off (CFEN_PALLAS_VIT unset), as by default.
The last two lines are a JSON object of the kernels' results and
{"ok": true, "device": {...}}.  Without CUDA it exits 1 and prints neither.
"""

from __future__ import annotations

import glob
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
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
# K5 against its twins.  Forward statistics: both sum cos in float32 from
# the same inputs, in another order (rtol 1e-4); an index may differ only
# where its value ties the twin's within that tolerance.  do/dt: float32
# sums over P terms in another order; bf16 outputs by a rounding flip;
# atol is that share of the largest |value|.
MRF_TOL = {"float32": (1e-3, 1e-4), "bfloat16": (2e-2, 1e-2)}
# the card's published peaks (H100 SXM, dense): float32 outside the
# tensor cores, bf16 tensor cores, HBM3
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12


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
    with open(lib._name[:-3] + ".log") as fh:
        for line in fh:
            if "Used" in line or "spill" in line:
                log("build", "ptxas " + line.strip().split(": ", 1)[-1])


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
    """The least time the card could take: the larger of the operations
    over the peak rate for the inputs' type and the bytes over HBM's."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


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
    for out_c in (3, 1):
        t2 = torch.relu(randn(BATCH, 12, SIDE, SIDE))
        args = [t2, randn(out_c, 12, 7, 7, std=(2 / 588) ** 0.5),
                randn(out_c, std=0.1)]
        px = BATCH * SIDE * SIDE
        cases.append(("tail", f"[{BATCH},12,{SIDE},{SIDE}] -> {out_c}",
                      cuda_tail.tail_epilogue, cuda_tail.tail_plain, args,
                      2.0 * px * 12 * 49 * out_c, px * (12 + out_c), None))
    x = torch.rand((BATCH, 3, SIDE, SIDE), generator=g, device=dev) * 2 - 1
    args = [x, randn(12, 3, 5, 5, std=(2 / 75) ** 0.5), randn(12, std=0.1),
            randn(12, 12, 3, 3, std=(2 / 108) ** 0.5), randn(12, std=0.1),
            randn(12, 12, 3, 3, std=(2 / 108) ** 0.5), randn(12, std=0.1)]
    px = BATCH * SIDE * SIDE
    cases.append(("stem", f"[{BATCH},3,{SIDE},{SIDE}] -> 12",
                  cuda_stem.fused_stem, cuda_stem.stem_plain, args,
                  2.0 * px * (3 * 25 * 12 + 2 * 12 * 9 * 12), px * 15, None))
    return cases


def _record(results, kernel, dn, err, ms, plain_ms, bound, library_ms=None,
            **summed):
    r = results.setdefault((kernel, dn), {
        "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
        "bound_by": bound[1], "library_ms": None})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["ms"] += ms
    r["plain_ms"] += plain_ms
    r["bound_ms"] += bound[0]
    if library_ms is not None:
        r["library_ms"] = (r["library_ms"] or 0.0) + library_ms
    for key, value in summed.items():
        r[key] = r.get(key, 0.0) + value


def phase_kernels(torch, spec, results):
    """K1, K3, K4 against their plain versions; adds per (kernel, dtype)
    the max error and the summed times and bounds over the shapes."""
    failures = []
    with torch.inference_mode():
        for (kernel, label, wrapper, plain, args, flops, elems,
             library) in kernel_cases(torch, spec):
            for dtype in (torch.float32, torch.bfloat16):
                dn = str(dtype).split(".")[-1]
                a = [t.to(dtype) if isinstance(t, torch.Tensor) else t
                     for t in args]
                got = wrapper(*a)
                torch.cuda.synchronize()
                ref = plain(*a)
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs().max().item()
                atol, rtol = TOL[dn]
                ok = bool(torch.allclose(got.float(), ref.float(), atol=atol,
                                         rtol=rtol))
                ms = time_ms(torch, lambda: wrapper(*a))
                plain_ms = time_ms(torch, lambda: plain(*a))
                lib_ms = library and time_ms(torch, lambda: library(*a))
                bound = bound_ms(flops, elems * a[0].element_size(), dn)
                lib = f", library {lib_ms:.4f} ms" if library else ""
                log("kernel", f"{kernel} {label} {dn}: max_abs_err {err:.3g} "
                    f"(atol {atol}, rtol {rtol}) {'ok' if ok else 'FAIL'}; "
                    f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{lib}, "
                    f"bound {bound[0]:.4f} ms ({bound[1]})")
                _record(results, kernel, dn, err, ms, plain_ms, bound,
                        lib_ms or None)
                if not ok:
                    failures.append(f"{kernel} {label} {dn}")
    if failures:
        raise AssertionError(f"kernels disagree with plain: {failures}")


def k2_blocks(spec):
    """(label, ViTSpec, rows) of the blocks K2 takes at batch 4: LViT L3 and
    GViT L1 by default, LViT L1 and L2 with CFEN_PALLAS_VIT_MIN_E=0."""
    tiles = {lvl: (spec.level_size(lvl) // spec.patch_size) ** 2
             for lvl in (1, 2, 3)}
    return [("LViT L3", spec.lvit_spec(3), BATCH * tiles[3]),
            ("GViT L1", spec.gvit_spec(1, encoder=False), BATCH),
            ("LViT L1", spec.lvit_spec(1), BATCH * tiles[1]),
            ("LViT L2", spec.lvit_spec(2), BATCH * tiles[2])]


def k2_case(torch, vspec, n, dtype, seed):
    """A ViT block with the generator's init plus random biases and
    LayerNorm affines (so every term counts), and seeded tokens, on the
    card in dtype."""
    from cfen_vit_tpu_torch.models.generator import init_weights
    from cfen_vit_tpu_torch.models.vit import ViT
    g = torch.Generator().manual_seed(seed)
    vit = init_weights(ViT(vspec), g)
    with torch.no_grad():
        for name, prm in vit.named_parameters():
            if name.endswith("bias") or "norm" in name:
                prm.add_(torch.randn(prm.shape, generator=g) * 0.1)
    t = torch.randn(n, vspec.seq_length, vspec.embedding_dim, generator=g)
    return vit.to("cuda", dtype).eval(), t.to("cuda", dtype)


def k2_cost(vspec, n, item):
    """Operations (the ten E x E linears, QK^T and PV, the two MLPs) and
    bytes (tokens in and out, the 5E^2 + 4EH + SE weights)."""
    s, e, h = vspec.seq_length, vspec.embedding_dim, vspec.hidden_dim
    flops = n * (10.0 * s * e * e + 4.0 * s * s * e + 8.0 * s * e * h)
    return flops, (2.0 * n * s * e + 5 * e * e + 4 * e * h + s * e) * item


def phase_fused_vit(torch, spec, results):
    """K2 against its twin at its four blocks, beside the unfused token
    path (ViT.tokens with K2 off: cuBLAS linears and K1) it replaces."""
    from cfen_vit_tpu_torch.ops import cuda_vit
    failures = []
    with torch.inference_mode():
        for label, vspec, n in k2_blocks(spec):
            for dtype in (torch.float32, torch.bfloat16):
                dn = str(dtype).split(".")[-1]
                vit, t = k2_case(torch, vspec, n, dtype, SEED)
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
                bound = bound_ms(*k2_cost(vspec, n, t.element_size()), dn)
                log("kernel", f"fused_vit {label} [{n},{vspec.seq_length},"
                    f"{vspec.embedding_dim}] h{heads} H{vspec.hidden_dim} {dn}: "
                    f"max_abs_err {err:.3g} of max |out| {top:.3g}, relative "
                    f"norm {rel:.3g} (atol {frac:.3g} x max, rtol {rtol}) "
                    f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, twin "
                    f"{plain_ms:.4f} ms, unfused {unfused_ms:.4f} ms, bound "
                    f"{bound[0]:.4f} ms ({bound[1]})")
                _record(results, "fused_vit", dn, err, ms, plain_ms, bound,
                        unfused_ms=unfused_ms)
                if not ok:
                    failures.append(f"fused_vit {label} {dn}")
                del vit, t, got, ref
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
    with torch.inference_mode():
        for n, p, c in MRF_SHAPES:
            for dtype in (torch.float32, torch.bfloat16):
                dn = str(dtype).split(".")[-1]
                o, t = _mrf_inputs(torch, n, p, c, dtype, SEED)
                item = o.element_size()
                stat_bytes = n * p * (4 + 4 + 8 + 4 + 8)
                got = M.mrf_forward_stats(o, t)
                torch.cuda.synchronize()
                ref = M.mrf_forward_stats_plain(o, t)
                err, ok, flips = _check_mrf_stats(torch, o, t, got, ref)
                ms = time_ms(torch, lambda: M.mrf_forward_stats(o, t), 5, 1)
                plain_ms = time_ms(torch, lambda: M.mrf_forward_stats_plain(
                    o, t), 5, 1)
                bound = bound_ms(2.0 * n * p * p * c,
                                 2 * n * p * c * item + stat_bytes, dn)
                log("kernel", f"mrf_fwd [{n},{p},{c}] {dn}: max_abs_err "
                    f"{err:.3g} (rtol 1e-4, atol 1e-6; {flips} index ties) "
                    f"{'ok' if ok else 'FAIL'}; kernel {ms:.3f} ms, plain "
                    f"{plain_ms:.3f} ms, bound {bound[0]:.3f} ms ({bound[1]})")
                _record(results, "mrf_fwd", dn, err, ms, plain_ms, bound)
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
                    ms = time_ms(torch, lambda: kern(*args), 5, 1)
                    plain_ms = time_ms(torch, lambda: twin(*args), 5, 1)
                    bound = bound_ms(4.0 * n * p * p * c,
                                     3 * n * p * c * item + stat_bytes, dn)
                    log("kernel", f"{name} [{n},{p},{c}] {dn}: max_abs_err "
                        f"{err:.3g} (rtol {rtol}, atol {frac} x max) "
                        f"{'ok' if ok else 'FAIL'}; kernel {ms:.3f} ms, "
                        f"plain {plain_ms:.3f} ms, bound {bound[0]:.3f} ms "
                        f"({bound[1]})")
                    _record(results, name, dn, err, ms, plain_ms, bound)
                    if not ok:
                        failures.append(f"{name} [{n},{p},{c}] {dn}")
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
        vit, t = k2_case(torch, vspec, n, dtype, SEED + 2)
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


def phase_e2e(torch, spec, tmp):
    """The inference CLI in float32 and bfloat16 under `tmp` (kept for the
    serve phase); returns the launch counts of each run and the bf16
    against float32 PSNR of the fake_A PNGs."""
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
    log("e2e", f"seeded v3 model, {sum(p.numel() for p in net.parameters())}"
        " parameters, ActNorms initialised on batch 0, saved 1_net_G.pth")
    del net

    def argv(dtype):
        return ["--dataroot", os.path.join(tmp, "data"), "--name", "smoke",
                "--checkpoints_dir", os.path.join(tmp, "ckpt"),
                "--results_dir", os.path.join(tmp, f"results_{dtype}"),
                "--model", "dec_vit", "--dataset_mode", "dec_vit",
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
        log("e2e", f"{dtype} CLI: {stats['images']} images in "
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
        log("e2e", f"{dtype} model.test() on device-resident weights: "
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
            log("e2e", f"float32 fake_A, kernels vs plain path: max "
                f"{diff:.0f}/255 (limit 2/255)")
            if diff > 2:
                raise AssertionError(f"kernel path is {diff}/255 off the "
                                     "plain path")
        del model
    mse = np.mean((outputs["bfloat16"] - outputs["float32"]) ** 2)
    psnr = 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))
    log("e2e", f"bfloat16 vs float32 fake_A: PSNR {psnr:.2f} dB "
        "(limit 35 dB)")
    if psnr <= 35.0:
        raise AssertionError(f"bfloat16 PSNR {psnr:.2f} dB <= 35 dB")
    per_image = [10 * np.log10(255.0 ** 2 / max(np.mean((b - f) ** 2), 1e-12))
                 for b, f in zip(outputs["bfloat16"], outputs["float32"])]
    log("e2e", f"bfloat16 vs float32 fake_A, mean of per-image PSNR "
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


def phase_train(torch, spec):
    """The GAN training step through its CLI, in float32 and bfloat16; returns
    the launch counts of each run."""
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
                    "--print_freq", str(BATCH), "--compute_dtype", dtype]
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
            log("train", f"{dtype}: {len(steps)} steps in {seconds:.2f} s "
                f"(run incl. data, checkpoints, LR updates); step seconds "
                f"{[round(x, 4) for x in steps]}; steady "
                f"{statistics.mean(steps[1:]):.4f} s/step after step 0; peak "
                f"device memory {peak:.2f} GiB; launches {launches[dtype]}")
            for i, losses in enumerate(run["losses"]):
                log("train", f"{dtype} step {i}: " + ", ".join(
                    f"{k} {v:.5g}" for k, v in losses.items()))
            if len(steps) != 2 * N_IMAGES // BATCH:
                raise AssertionError(f"{dtype}: {len(steps)} steps, expected "
                                     f"{2 * N_IMAGES // BATCH}")
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
            log("train", f"{dtype}: share of tensors moved: G and D "
                f"{moved['']:.3f}, D {moved['D.']:.3f}")
            if moved["D."] < 0.99 or moved[""] < 0.99:
                raise AssertionError(f"{dtype}: parameters did not move: {moved}")
            missing = [k for k, v in launches[dtype].items() if not v]
            if missing:
                raise AssertionError(f"{dtype}: never launched or recomputed "
                                     f"on the training path: {missing}")
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
            log("train", f"{dtype}: test CLI read 2_net_G.pth, wrote "
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from cfen_vit_tpu_torch.config import set_precision
    from cfen_vit_tpu_torch.models.registry import generator_spec

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
    ported = [m for m in sys.modules
              if m == "jax" or m.startswith("jax.") or m == "cfen_vit_tpu"
              or m.startswith("cfen_vit_tpu.")]
    if ported:
        raise AssertionError(f"the port imported {sorted(ported)[:5]}")

    entries = []
    for (kernel, dtype), r in results.items():
        source, replaces = KERNELS[kernel]
        # K2's main path is serving; every other kernel's is training
        main_path = serve_launches if kernel == "fused_vit" else train_launches
        entries.append({"name": f"{kernel} {dtype}", "route": "cuda",
                        "source": source, "replaces": replaces,
                        "launches": main_path[dtype][kernel],
                        "launches_inference": infer_launches[dtype].get(kernel, 0),
                        "launches_serve": serve_launches[dtype].get(kernel, 0),
                        **r})
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
