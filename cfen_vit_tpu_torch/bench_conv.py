"""Benchmark of the port's kernels on the card: K3 (the tail epilogue,
csrc/tail.cu), K4 (the stem, csrc/stem.cu), K2 (the ViT token block,
csrc/vit.cu) and K6 (the deformable conv, csrc/deform.cu).

    python -m cfen_vit_tpu_torch.bench_conv [--mode times|parity|split|tiles]
        [--against DIR] [--kernels tail,stem,fused_vit,deform]

`times`: in each dtype, K3 at input widths 12, 16 and 24 into 3 and 1
channels and K4 at stem widths 4 to 146, at batch 4 and 512x512; K2 at the
four blocks chip_smoke.py's phase 3 times (the canonical model at batch
4); K6 at bench_deform's four geometries.  Each line gives the device
time of one call, every kernel the call launches summed (torch.profiler's
CUDA activity over 20 calls after a warm-up; 5 for K4 above width 64),
and the median CUDA-event time of a call synchronised after each, as
chip_smoke.py times it (which includes the host's share, the larger part
for a short kernel).  K2's lines split the device time into its linears
(`linear_kernel`), its attention (`attn`) and the rest, and this tree's
lines give the unfused token path's times beside them (ViT.tokens with
K2 off: cuBLAS linears and K1).  With `--against DIR`, a checkout of
another commit (e.g. the parent, unpacked with `git archive` into a
git-ignored directory), the two are timed in turns, other, this, this,
other, each turn a process of its own; the other checkout's wrappers are
imported from it under another name and build its own kernels into its
own `_build/`.

`parity`: K4 with its ResBlock zeroed, whose output is then h, against
F.conv2d's h, and K4 against `stem_plain`, in both dtypes at the stem
widths of phases 3 and 8 (12 and 16): how many values differ and by how
much.  In bf16 a rounding flip of h is what moves K4's output furthest
from the plain version's (csrc/stem.cu).

`tiles`: K2's linear kernel alone (csrc/vit.cu `cfen_vit_linear`, out =
relu(a w^T + bias)) at every linear of the four blocks `times` runs, (n,
k) = (E, E), (3E, E), (H, E) and (E, H) at m = N S rows, in each dtype,
on each of vit.cu's block tiles (`kTiles`, by index) and on the one
`pick` chooses: the device time of each (profiler, 20 calls), the tile
pick chose and the fastest.  Then, per dtype, each tile's rate against
tile 0 at LViT L1's m 65536 (where every tile fills the card): t0 / t,
the geometric mean over its linears, the figure `kTiles` holds.

`split`: csrc/stem.cu built alone six times, with a phase compiled out
of each (the head conv, the first 3x3, the second 3x3, the weight
staging, all three convs), and timed at width 12 in both dtypes; and
csrc/deform.cu built whole and with its product compiled out, timed at
bench_deform's geometries in both dtypes (every kernel of a call): the
whole kernel less a variant is that phase's share.  The variants are made
by editing a copy of the source at fixed lines, which must still be
there.

Every line printed is one JSON object, with the card's name and power
limit in the first.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import importlib.util
import json
import os
import subprocess
import statistics
import sys
from dataclasses import replace
from pathlib import Path

import torch
import torch.nn.functional as F

from . import bench_deform
from .bench_cases import device_ms, device_times, event_ms, k2_blocks, k2_case
from .config import set_precision
from .ops import _build, cuda_stem, cuda_tail, cuda_vit, deform_conv

BATCH, SIDE = 4, 512
TAIL_WIDTHS = (12, 16, 24)
STEM_WIDTHS = (4, 12, 16, 32, 64, 146)
KERNELS = ("tail", "stem", "fused_vit", "deform")
# the canonical v3 model as chip_smoke.py builds it
CANONICAL = dict(n_feats=24, hidden_dim_ratio=4, patch_size=32, load_size=256)
# the phases `split` compiles out, by kernel: the source, its hooks
# (text, replacement) and the variants (the hooks each leaves out)
_SPLITS = {
    "stem": ("stem.cu", "cfen_stem_fwd", {
        "head": ("      for (int p0 = tid; p0 < hh * hw; p0 += Q * kThreads) {",
                 "      for (int p0 = SKIP_HEAD ? hh * hw : tid; p0 < hh * hw; p0 += Q * kThreads) {"),
        "conv1": ("    sweep(rh, rw, hs, hw,", "    if (!SKIP_CONV1) sweep(rh, rw, hs, hw,"),
        "conv2": ("    sweep(th, tw, rs, rw,", "    if (!SKIP_CONV2) sweep(th, tw, rs, rw,"),
        "stage": ("    stage(w", "    if (!SKIP_STAGE) stage(w"),
    }, {"whole": (), "no_head": ("head",), "no_conv1": ("conv1",), "no_conv2": ("conv2",),
        "no_stage": ("stage",), "no_convs": ("head", "conv1", "conv2")}),
    "deform": ("deform.cu", "cfen_deform_fwd", {
        "mma": ("      if constexpr (sizeof(T) == 2) {",
                "      if constexpr (SKIP_MMA) {\n      } else if constexpr (sizeof(T) == 2) {"),
    }, {"whole": (), "no_mma": ("mma",)}),
}


def _print(record: dict) -> None:
    print(json.dumps(record), flush=True)


def load_checkout(root: Path) -> dict:
    """The wrappers of the checkout at root by kernel, its package imported
    under another name so that both checkouts' wrappers live side by side."""
    pkg = root / "cfen_vit_tpu_torch"
    name = "cfen_vit_tpu_torch_other"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return {kernel: importlib.import_module(f"{name}.ops.{mod}") for kernel, mod in
            (("tail", "cuda_tail"), ("stem", "cuda_stem"), ("fused_vit", "cuda_vit"),
             ("deform", "deform_conv"))}


def _tail_args(g, dtype, c, out_c):
    t2 = torch.randn((BATCH, c, SIDE, SIDE), generator=g, device="cuda").relu()
    w = torch.randn((out_c, c, 7, 7), generator=g, device="cuda") * (2 / (49 * c)) ** 0.5
    b = torch.randn(out_c, generator=g, device="cuda") * 0.1
    return [t.to(dtype) for t in (t2, w, b)]


def _stem_args(g, dtype, cm):
    x = torch.rand((BATCH, 3, SIDE, SIDE), generator=g, device="cuda") * 2 - 1
    std3 = (2 / (9 * cm)) ** 0.5
    shapes = (((cm, 3, 5, 5), (2 / 75) ** 0.5), ((cm,), 0.1), ((cm, cm, 3, 3), std3),
              ((cm,), 0.1), ((cm, cm, 3, 3), std3), ((cm,), 0.1))
    return [t.to(dtype) for t in
            [x] + [torch.randn(s, generator=g, device="cuda") * std for s, std in shapes]]


def _round(ms):
    return None if ms is None else round(ms, 4)


def _split(times: dict | None) -> dict:
    """K2's device time by part: its linears, its attention, the rest
    (None where the profiler's trace was not whole)."""
    parts = {"linear_ms": 0.0, "attention_ms": 0.0, "other_ms": 0.0}
    if times is None:
        return dict.fromkeys(parts)
    for name, ms in times.items():
        key = ("linear_ms" if "linear_kernel" in name else
               "attention_ms" if "attn" in name else "other_ms")
        parts[key] += ms
    return {k: round(v, 4) for k, v in parts.items()}


def _time_cases(kernels):
    """(kernel, label, dtype, call(tree's wrappers), reps, extra fields of
    this tree's lines) for the kernels asked for."""
    from .models.registry import generator_spec
    g = torch.Generator(device="cuda").manual_seed(0)
    spec = replace(generator_spec("iid_hlgvit_crs_gd4_cfs_v3"), **CANONICAL)
    for dtype in (torch.float32, torch.bfloat16):
        if "tail" in kernels:
            for c in TAIL_WIDTHS:
                for oc in (3, 1):
                    args = _tail_args(g, dtype, c, oc)
                    yield ("tail", f"{c}->{oc}", dtype,
                           lambda m, a=args: m.tail_epilogue(*a), 20, None)
        if "stem" in kernels:
            for cm in STEM_WIDTHS:
                args = _stem_args(g, dtype, cm)
                yield ("stem", f"{cm}", dtype, lambda m, a=args: m.fused_stem(*a),
                       5 if cm > 64 else 20, None)
        if "fused_vit" in kernels:
            for label, vspec, n in k2_blocks(spec):
                vit, t = k2_case(vspec, n, dtype, 0)
                w, heads = vit.fused_weights(), vspec.num_heads
                yield ("fused_vit", f"{label} [{n},{vspec.seq_length},"
                       f"{vspec.embedding_dim}]", dtype,
                       lambda m, t=t, w=w, h=heads: m.fused_tokens(t, w, h), 20,
                       lambda v=vit, t=t: v.tokens(t))
        if "deform" in kernels:
            for n, h, w, cin, cout, k in bench_deform.GEOMETRIES:
                args = bench_deform.inputs(n, h, w, cin, cout, k, dtype, "cuda")
                yield ("deform", f"{n}x{h}x{w}x{cin}->{cout} k{k}", dtype,
                       lambda m, a=args, k=k: m.modulated_deform_conv(*a, 1, k // 2, 1),
                       20, None)


def mode_times(kernels, wrappers: Path | None, turn: int) -> None:
    """One turn: this checkout's wrappers, or those of the checkout at
    `wrappers` ("other")."""
    mods = ({"tail": cuda_tail, "stem": cuda_stem, "fused_vit": cuda_vit,
             "deform": deform_conv} if wrappers is None else load_checkout(wrappers))
    tree = "this" if wrappers is None else "other"
    with torch.inference_mode():
        for kernel, label, dtype, call, reps, unfused in _time_cases(kernels):
            fn = (lambda c=call, m=mods[kernel]: c(m))
            times = device_times(fn, reps)
            record = {"kernel": kernel, "width" if kernel in ("tail", "stem")
                      else "shape": label, "dtype": str(dtype)[6:], "tree": tree,
                      "turn": turn,
                      "device_ms": _round(None if times is None else sum(times.values())),
                      "event_ms": round(event_ms(fn, reps), 4)}
            if kernel == "fused_vit":
                record.update(_split(times))
                if tree == "this":
                    record["unfused_device_ms"] = _round(device_ms(unfused, "", reps))
                    record["unfused_event_ms"] = round(event_ms(unfused, reps), 4)
            _print(record)


def times_in_turns(against: Path, kernels) -> None:
    """Other, this, this, other: each turn a process of its own that loads
    one checkout's kernel library (with both loaded in one process, the
    second checkout's K2 launch returned `invalid argument` on the card)."""
    for turn, tree in enumerate(("other", "this", "this", "other")):
        cmd = [sys.executable, "-m", "cfen_vit_tpu_torch.bench_conv", "--mode", "times",
               "--kernels", ",".join(kernels), "--turn", str(turn)]
        if tree == "other":
            cmd += ["--wrappers", str(against.resolve())]
        subprocess.run(cmd, check=True, cwd=Path(__file__).resolve().parent.parent)


def mode_parity() -> None:
    g = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        for cm in (12, 16):
            for dtype in (torch.float32, torch.bfloat16):
                x, w5, b5, w1, b1, w2, b2 = _stem_args(g, dtype, cm)
                zeros = [torch.zeros_like(t) for t in (w1, b1, w2, b2)]
                h_kernel = cuda_stem.fused_stem(x, w5, b5, *zeros).double()
                h_plain = F.conv2d(x, w5, b5, padding=2).double()
                got = cuda_stem.fused_stem(x, w5, b5, w1, b1, w2, b2).double()
                ref = cuda_stem.stem_plain(x, w5, b5, w1, b1, w2, b2).double()
                _print({"cm": cm, "dtype": str(dtype)[6:], "values": h_plain.numel(),
                        "h_differ": int((h_kernel != h_plain).sum()),
                        "h_max_diff": (h_kernel - h_plain).abs().max().item(),
                        "out_differ": int((got != ref).sum()),
                        "out_max_diff": (got - ref).abs().max().item()})


def _split_libs(kernel: str, out_dir: Path) -> dict:
    """The kernel's source built alone once a variant (nvcc started
    together); its entry point by variant."""
    name, entry, hooks, variants = _SPLITS[kernel]
    source = (_build.CSRC / name).read_text()
    for old, new in hooks.values():
        if old not in source:
            raise RuntimeError(f"bench_conv --mode split: csrc/{name} no longer has {old!r}")
        source = source.replace(old, new)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{kernel}_split.cu"
    path.write_text(source)
    jobs = {}
    for variant, skipped in variants.items():
        flags = [f"-DSKIP_{hook.upper()}={int(hook in skipped)}" for hook in hooks]
        lib = out_dir / f"lib{kernel}_{variant}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC),
               *flags, str(path), "-o", str(lib)]
        jobs[variant] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True))
    libs = {}
    for variant, (lib, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {kernel} {variant}:\n{out}")
        fn = getattr(ctypes.CDLL(str(lib)), entry)
        fn.argtypes = _build._SIGNATURES[entry]
        fn.restype = ctypes.c_int
        libs[variant] = fn
    return libs


def _checked(fn, variant, *args):
    def run():
        rc = fn(*args)
        if rc:
            raise RuntimeError(f"{fn.__name__} ({variant}): CUDA error {rc}")
    return run


def mode_tiles() -> None:
    from .models.registry import generator_spec
    spec = replace(generator_spec("iid_hlgvit_crs_gd4_cfs_v3"), **CANONICAL)
    lib = _build.library()
    g = torch.Generator(device="cuda").manual_seed(0)
    used = ctypes.c_int(0)
    for dtype in (torch.float32, torch.bfloat16):
        ratios = {}
        for label, vspec, rows in k2_blocks(spec):
            m, e, hid = rows * vspec.seq_length, vspec.embedding_dim, vspec.hidden_dim
            for n, k in ((e, e), (3 * e, e), (hid, e), (e, hid)):
                a = torch.randn((m, k), generator=g, device="cuda").to(dtype)
                w = (torch.randn((n, k), generator=g, device="cuda") * k ** -0.5).to(dtype)
                b = (torch.randn(n, generator=g, device="cuda") * 0.1).to(dtype)
                out = torch.empty((m, n), device="cuda", dtype=dtype)
                record = {"kernel": "linear", "block": label, "m": m, "n": n, "k": k,
                          "dtype": str(dtype)[6:]}
                times = {}
                for tile in (0, 1, 2, 3, -1):
                    def run(tile=tile):
                        rc = lib.cfen_vit_linear(a.data_ptr(), w.data_ptr(), b.data_ptr(),
                                                 out.data_ptr(), m, n, k, tile,
                                                 _build.dtype_code(a), ctypes.byref(used),
                                                 _build.stream(a))
                        _build.check(rc, "cfen_vit_linear")
                    ms = device_ms(run, "linear_kernel")
                    us = None if ms is None else round(ms * 1e3, 2)
                    if tile < 0:
                        record["pick"], record["pick_us"] = used.value, us
                    elif ms is not None:
                        times[tile] = ms
                        record[f"tile{tile}_us"] = us
                record["fastest"] = min(times, key=times.get) if times else None
                _print(record)
                if m == 65536 and 0 in times:
                    for tile, ms in times.items():
                        ratios.setdefault(tile, []).append(times[0] / ms)
        _print({"dtype": str(dtype)[6:], "rates_at_m_65536": [
            round(statistics.geometric_mean(ratios[t]), 3) for t in sorted(ratios)]})


def mode_split(out_dir: Path, kernels) -> None:
    g = torch.Generator(device="cuda").manual_seed(0)
    if "stem" in kernels:
        cm = 12
        libs = _split_libs("stem", out_dir)
        for dtype in (torch.float32, torch.bfloat16):
            args = _stem_args(g, dtype, cm)
            out = torch.empty((BATCH, cm, SIDE, SIDE), device="cuda", dtype=dtype)
            for variant, fn in libs.items():
                run = _checked(fn, variant, *(t.data_ptr() for t in args), out.data_ptr(),
                               BATCH, 3, cm, SIDE, SIDE, _build.dtype_code(out),
                               _build.stream(out))
                _print({"kernel": "stem", "variant": variant, "cm": cm,
                        "dtype": str(dtype)[6:],
                        "device_ms": _round(device_ms(run, "stem_kernel"))})
    if "deform" in kernels:   # every kernel of a call: the copies and the product
        from .ops.cuda_deform import scratch_elems
        libs = _split_libs("deform", out_dir)
        for dtype in (torch.float32, torch.bfloat16):
            for n, h, w, cin, cout, k in bench_deform.GEOMETRIES:
                x, off, mask, wt, b = bench_deform.inputs(n, h, w, cin, cout, k, dtype, "cuda")
                out = torch.empty((n, cout, h, w), device="cuda", dtype=dtype)
                scratch = torch.empty(scratch_elems(n, cin, h, w, cout, k, h * w, dtype),
                                      device="cuda", dtype=dtype)
                for variant, fn in libs.items():
                    run = _checked(fn, variant, *(t.data_ptr() for t in (x, off, mask, wt, b)),
                                   out.data_ptr(), scratch.data_ptr(), n, cin, h, w, cout, k,
                                   h, w, 1, k // 2, 1, _build.dtype_code(out),
                                   _build.stream(out))
                    _print({"kernel": "deform", "variant": variant,
                            "shape": f"{n}x{h}x{w}x{cin}->{cout} k{k}",
                            "dtype": str(dtype)[6:], "device_ms": _round(device_ms(run))})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("times", "parity", "split", "tiles"),
                    default="times")
    ap.add_argument("--against", type=Path, default=None,
                    help="a checkout of another commit to time in turns with this one")
    ap.add_argument("--wrappers", type=Path, default=None,
                    help="(one turn of --against) time the wrappers of the checkout at this path")
    ap.add_argument("--turn", type=int, default=0, help="(one turn of --against)")
    ap.add_argument("--split_dir", type=Path, default=_build.BUILD_DIR / "split",
                    help="where `split` builds its variants")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma list of the kernels `times` (and `split`: stem, deform) "
                         "takes: " + ", ".join(KERNELS))
    args = ap.parse_args(argv)
    kernels = [k for k in args.kernels.split(",") if k]
    if set(kernels) - set(KERNELS):
        ap.error(f"--kernels takes {', '.join(KERNELS)}, got {args.kernels}")
    if not torch.cuda.is_available():
        print("bench_conv: the kernels run only on the card", file=sys.stderr)
        return 1
    set_precision("highest")
    os.environ.pop("CFEN_PALLAS_VIT", None)   # ViT.tokens: the unfused path
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    _print({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi.stdout.strip()})
    if args.mode == "times":
        if args.against is not None:
            times_in_turns(args.against, kernels)
        else:
            mode_times(kernels, args.wrappers, args.turn)
    elif args.mode == "parity":
        mode_parity()
    elif args.mode == "tiles":
        mode_tiles()
    else:
        mode_split(args.split_dir, kernels)
    return 0


if __name__ == "__main__":
    sys.exit(main())
