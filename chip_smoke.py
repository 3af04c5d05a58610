#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each printing its own lines; any failure raises (non-zero exit):

  1. environment: the card's name and power limit (nvidia-smi), torch,
     CUDA and nvcc versions, whether Pillow imports;
  2. build: compiles cfen_vit_tpu_torch/csrc/*.cu (ops/_build.py);
  3. kernels: K1 attention at the six ViT shapes of the canonical v3 model
     at batch 4, K3 tail and K4 stem at 512x512, in float32 and bfloat16,
     each against its plain PyTorch version on the card (max abs error,
     tolerance, median CUDA-event times);
  4. end to end: a seeded full-width v3 model (n_feats 24,
     hidden_dim_ratio 4, patch 32, loadSize 256) with its ActNorms
     initialised on the first batch, saved as 1_net_G.pth, then
     `cfen_vit_tpu_torch.test --out_all --batchSize 4 --gpu_ids 0` over 8
     seeded 512x512 hazy PNGs, in float32 and bfloat16.  It checks the
     PNGs, that every kernel launched during the CLI run, that fake_A is
     within 2/255 of the same model on the plain path, and that bfloat16
     is above 35 dB PSNR against float32.

The last two lines are a JSON object of the kernels' results and
{"ok": true, "device": {...}}.  Without CUDA it exits 1 and prints neither.
"""

from __future__ import annotations

import glob
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from contextlib import ExitStack
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
}


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


def kernel_cases(torch, spec):
    """(kernel, label, wrapper, plain, args) at the main path's shapes."""
    from cfen_vit_tpu_torch.ops import cuda_attn, cuda_stem, cuda_tail
    g = torch.Generator(device="cuda").manual_seed(SEED)
    dev = "cuda"

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=dev) * std

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
                          args))
    for out_c in (3, 1):
        t2 = torch.relu(randn(BATCH, 12, SIDE, SIDE))
        args = [t2, randn(out_c, 12, 7, 7, std=(2 / 588) ** 0.5),
                randn(out_c, std=0.1)]
        cases.append(("tail", f"[{BATCH},12,{SIDE},{SIDE}] -> {out_c}",
                      cuda_tail.tail_epilogue, cuda_tail.tail_plain, args))
    x = torch.rand((BATCH, 3, SIDE, SIDE), generator=g, device=dev) * 2 - 1
    args = [x, randn(12, 3, 5, 5, std=(2 / 75) ** 0.5), randn(12, std=0.1),
            randn(12, 12, 3, 3, std=(2 / 108) ** 0.5), randn(12, std=0.1),
            randn(12, 12, 3, 3, std=(2 / 108) ** 0.5), randn(12, std=0.1)]
    cases.append(("stem", f"[{BATCH},3,{SIDE},{SIDE}] -> 12",
                  cuda_stem.fused_stem, cuda_stem.stem_plain, args))
    return cases


def phase_kernels(torch, spec):
    """Each kernel against its plain version; returns per (kernel, dtype)
    the max error and summed median times over the shapes."""
    results, failures = {}, []
    with torch.inference_mode():
        for kernel, label, wrapper, plain, args in kernel_cases(torch, spec):
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
                log("kernel", f"{kernel} {label} {dn}: max_abs_err {err:.3g} "
                    f"(atol {atol}, rtol {rtol}) {'ok' if ok else 'FAIL'}; "
                    f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
                r = results.setdefault((kernel, dn), {"max_abs_err": 0.0,
                                                      "ms": 0.0,
                                                      "plain_ms": 0.0})
                r["max_abs_err"] = max(r["max_abs_err"], err)
                r["ms"] += ms
                r["plain_ms"] += plain_ms
                if not ok:
                    failures.append(f"{kernel} {label} {dn}")
    if failures:
        raise AssertionError(f"kernels disagree with plain: {failures}")
    return results


def write_hazy_pngs(root: str) -> list:
    """Seeded smooth scenes through the atmospheric scattering model
    I = J t + A (1 - t), as uint8 PNGs under root/hazy/."""
    from PIL import Image
    import torch
    import torch.nn.functional as F
    rng = np.random.RandomState(SEED)
    os.makedirs(os.path.join(root, "hazy"))
    paths = []
    for i in range(N_IMAGES):
        low = torch.from_numpy(rng.rand(1, 4, 16, 16).astype(np.float32))
        up = F.interpolate(low, size=(SIDE, SIDE), mode="bilinear",
                           align_corners=False)[0].numpy()
        scene, t = up[:3].transpose(1, 2, 0), 0.3 + 0.6 * up[3][..., None]
        hazy = scene * t + 0.9 * (1 - t) + rng.randn(SIDE, SIDE, 3) * 0.01
        path = os.path.join(root, "hazy", f"hazy_{i:02d}.png")
        Image.fromarray(np.clip(hazy * 255, 0, 255).astype(np.uint8)).save(path)
        paths.append(path)
    return paths


def read_png(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def phase_e2e(torch, spec):
    from cfen_vit_tpu_torch import test as cli
    from cfen_vit_tpu_torch.config import parse_args
    from cfen_vit_tpu_torch.models.dehazing_model import DehazingModel
    from cfen_vit_tpu_torch.models.generator import Generator, init_weights
    from cfen_vit_tpu_torch.ops import cuda_attn, cuda_stem, cuda_tail
    wrappers = {"attention": cuda_attn, "tail": cuda_tail, "stem": cuda_stem}

    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=REPO) as tmp:
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

            model = DehazingModel(parse_args(argv(dtype)), torch.device("cuda"))
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

    spec = replace(generator_spec("iid_hlgvit_crs_gd4_cfs_v3"), n_feats=24,
                   hidden_dim_ratio=4, patch_size=32, load_size=256)
    set_precision("highest")   # float32 plain versions without TF32
    phase_env(torch)
    phase_build()
    results = phase_kernels(torch, spec)
    launches = phase_e2e(torch, spec)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    entries = []
    for (kernel, dtype), r in results.items():
        source, replaces = KERNELS[kernel]
        entries.append({"name": f"{kernel} {dtype}", "route": "cuda",
                        "source": source, "replaces": replaces,
                        "launches": launches[dtype][kernel],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
