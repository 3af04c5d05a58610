"""Benchmark of K3 (the tail epilogue, csrc/tail.cu) and K4 (the stem,
csrc/stem.cu) on the card.

    python -m cfen_vit_tpu_torch.bench_conv [--mode times|parity|split]
        [--against DIR]

`times`: in each dtype, K3 at input widths 12, 16 and 24 into 3 and 1
channels and K4 at stem widths 4 to 146, at batch 4 and 512x512: the
kernel's device time per launch (torch.profiler's CUDA activity over 20
launches after a warm-up; 5 above width 64) and the median CUDA-event
time of a launch synchronised after each, as chip_smoke.py's phase 3 times
it (which includes the host's share, the larger part for a short kernel).
With `--against DIR`, a checkout of another commit (e.g. the parent,
unpacked with `git archive` into a git-ignored directory), that checkout's
wrappers are imported from it under another name, build its own kernels
into its own `_build/`, and the two are timed in turns: other, this, this,
other.

`parity`: K4 with its ResBlock zeroed, whose output is then h, against
F.conv2d's h, and K4 against `stem_plain`, in both dtypes at the stem
widths of phases 3 and 8 (12 and 16): how many values differ and by how
much.  In bf16 a rounding flip of h is what moves K4's output furthest
from the plain version's (csrc/stem.cu).

`split`: csrc/stem.cu built alone six times, with a phase compiled out
of each (the head conv, the first 3x3, the second 3x3, the weight
staging, all three convs), and timed at width 12 in both dtypes: the
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
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from .config import set_precision
from .ops import _build, cuda_stem, cuda_tail

BATCH, SIDE = 4, 512
TAIL_WIDTHS = (12, 16, 24)
STEM_WIDTHS = (4, 12, 16, 32, 64, 146)
# phases of csrc/stem.cu compiled out by `split`: (text, replacement)
_HOOKS = {
    "head": ("      for (int p0 = tid; p0 < hh * hw; p0 += Q * kThreads) {",
             "      for (int p0 = SKIP_HEAD ? hh * hw : tid; p0 < hh * hw; p0 += Q * kThreads) {"),
    "conv1": ("    sweep(rh, rw, hs, hw,", "    if (!SKIP_CONV1) sweep(rh, rw, hs, hw,"),
    "conv2": ("    sweep(th, tw, rs, rw,", "    if (!SKIP_CONV2) sweep(th, tw, rs, rw,"),
    "stage": ("    stage(w", "    if (!SKIP_STAGE) stage(w"),
}
_VARIANTS = {"whole": (), "no_head": ("head",), "no_conv1": ("conv1",),
             "no_conv2": ("conv2",), "no_stage": ("stage",),
             "no_convs": ("head", "conv1", "conv2")}


def _print(record: dict) -> None:
    print(json.dumps(record), flush=True)


def device_ms(fn, kernel_name: str, reps: int = 20) -> float:
    """Device time of one launch of the kernels whose name contains
    kernel_name, from torch.profiler's CUDA activity."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum((getattr(e, "self_device_time_total", 0)
                 or getattr(e, "self_cuda_time_total", 0))
                for e in prof.key_averages() if kernel_name in e.key)
    return total / 1e3 / reps


def event_ms(fn, reps: int = 20) -> float:
    """Median CUDA-event time of fn, synchronising after every launch."""
    for _ in range(3):
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


def load_checkout(root: Path):
    """(cuda_tail, cuda_stem) of the checkout at root, its package imported
    under another name so that both checkouts' wrappers live side by side."""
    pkg = root / "cfen_vit_tpu_torch"
    name = "cfen_vit_tpu_torch_other"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return (importlib.import_module(f"{name}.ops.cuda_tail"),
            importlib.import_module(f"{name}.ops.cuda_stem"))


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


def mode_times(against: Path | None) -> None:
    trees = [("this", cuda_tail, cuda_stem)]
    if against is not None:
        other = ("other", *load_checkout(against))
        trees = [other, trees[0], trees[0], other]
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases += [("tail", f"{c}->{oc}", dtype, _tail_args(g, dtype, c, oc))
                  for c in TAIL_WIDTHS for oc in (3, 1)]
        cases += [("stem", f"{cm}", dtype, _stem_args(g, dtype, cm)) for cm in STEM_WIDTHS]
    with torch.inference_mode():
        for kernel, width, dtype, args in cases:
            reps = 5 if kernel == "stem" and int(width) > 64 else 20
            for turn, (tree, tail, stem) in enumerate(trees):
                fn = ((lambda a=args, m=tail: m.tail_epilogue(*a)) if kernel == "tail"
                      else (lambda a=args, m=stem: m.fused_stem(*a)))
                name = "tail_" if kernel == "tail" else "stem_kernel"
                _print({"kernel": kernel, "width": width, "dtype": str(dtype)[6:],
                        "tree": tree, "turn": turn,
                        "device_ms": round(device_ms(fn, name, reps), 4),
                        "event_ms": round(event_ms(fn, reps), 4)})


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


def mode_split(out_dir: Path) -> None:
    source = (_build.CSRC / "stem.cu").read_text()
    for old, new in _HOOKS.values():
        if old not in source:
            raise RuntimeError(f"bench_conv --mode split: csrc/stem.cu no longer has {old!r}")
        source = source.replace(old, new)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "stem_split.cu"
    path.write_text(source)
    jobs = {}
    for variant, skipped in _VARIANTS.items():
        flags = [f"-DSKIP_{hook.upper()}={int(hook in skipped)}" for hook in _HOOKS]
        lib = out_dir / f"libstem_{variant}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC),
               *flags, str(path), "-o", str(lib)]
        jobs[variant] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True))
    libs = {}
    for variant, (lib, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {variant}:\n{out}")
        fn = ctypes.CDLL(str(lib)).cfen_stem_fwd
        fn.argtypes = _build._SIGNATURES["cfen_stem_fwd"]
        fn.restype = ctypes.c_int
        libs[variant] = fn
    g = torch.Generator(device="cuda").manual_seed(0)
    cm = 12
    for dtype in (torch.float32, torch.bfloat16):
        args = _stem_args(g, dtype, cm)
        out = torch.empty((BATCH, cm, SIDE, SIDE), device="cuda", dtype=dtype)
        for variant, fn in libs.items():
            def run(fn=fn):
                rc = fn(*(t.data_ptr() for t in args), out.data_ptr(), BATCH, 3, cm, SIDE,
                        SIDE, _build.dtype_code(out), _build.stream(out))
                if rc:
                    raise RuntimeError(f"cfen_stem_fwd ({variant}): CUDA error {rc}")
            _print({"variant": variant, "cm": cm, "dtype": str(dtype)[6:],
                    "device_ms": round(device_ms(run, "stem_kernel"), 4)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("times", "parity", "split"), default="times")
    ap.add_argument("--against", type=Path, default=None,
                    help="a checkout of another commit to time in turns with this one")
    ap.add_argument("--split_dir", type=Path, default=_build.BUILD_DIR / "split",
                    help="where `split` builds its variants")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_conv: the kernels run only on the card", file=sys.stderr)
        return 1
    set_precision("highest")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    _print({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi.stdout.strip()})
    if args.mode == "times":
        mode_times(args.against)
    elif args.mode == "parity":
        mode_parity()
    else:
        mode_split(args.split_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
