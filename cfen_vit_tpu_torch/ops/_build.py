"""Builds the CUDA kernels in csrc/ and binds them with ctypes.

On first use, `library()` compiles every `csrc/*.cu` with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c

one nvcc process per source, all started together, and links the objects
into one shared library under `cfen_vit_tpu_torch/_build/` (git-ignored),
named by a hash of the sources and flags so an edited source rebuilds.
ptxas' register and shared-memory report lands beside it as `<lib>.log`.
The sources include no PyTorch header, so the build takes seconds.

Every C entry point takes its pointers and the CUDA stream as `void*` and
returns `cudaGetLastError()` after the launch; `check()` raises on a
non-zero code, since a refused launch never runs and a later synchronize
does not report it.  Nothing here is imported or built when a module of
this package is imported, and nothing runs on a CPU tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# entry point -> argtypes (pointers, ints, dtype code, stream)
_SIGNATURES = {
    "cfen_attn_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "cfen_tail_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "cfen_stem_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                      _I, _P],
    # cm, dtype, int[4] out: tile rows, cols, n8 tiles a chunk, smem bytes
    "cfen_stem_plan": [_I, _I, ctypes.POINTER(_I)],
    "cfen_mrf_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "cfen_mrf_bwd_do": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _P],
    "cfen_mrf_bwd_dt": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # t, the array of 17 weight pointers, out, scratch
    "cfen_vit_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # one of K2's linears: a, w, bias, out; m, n, k, tile, dtype, int* tile used
    "cfen_vit_linear": [_P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.POINTER(_I), _P],
    # x, offset, mask, w, b (or null), out, scratch; n, c, h, w, o, k, oh,
    # ow, stride, pad, dilation, dtype
    "cfen_deform_fwd": [_P] * 7 + [_I] * 12 + [_P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    for cand in (shutil.which("nvcc"),
                 os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "csrc/ on first use and need the CUDA toolkit")


def _build() -> Path:
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for path in sources + sorted(CSRC.glob("*.cuh")):
        digest.update(path.name.encode() + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"libcfen_kernels_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    work = BUILD_DIR / f"{lib.stem}.{os.getpid()}"
    work.mkdir(exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for src in sources:
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o",
               str(work / f"{src.stem}.o")]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True)))
    link = [nvcc, "-shared", "-o", str(work / lib.name),
            *(str(work / f"{src.stem}.o") for src in sources)]
    log, failed = [], []
    for cmd, proc in jobs:
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(f"{cmd[-3]} ({proc.returncode}):\n{out}")
    if not failed:
        res = subprocess.run(link, capture_output=True, text=True)
        log.append(" ".join(link) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(f"link ({res.returncode}):\n{res.stderr}")
    lib.with_suffix(".log").write_text("".join(log))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(work / lib.name, lib)
    shutil.rmtree(work, ignore_errors=True)
    return lib


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.cfen_error_string.argtypes = [ctypes.c_int]
            lib.cfen_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = library().cfen_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t: torch.Tensor) -> int:
    return _DTYPE_CODES[t.dtype]


def check_cuda_inputs(name: str, *tensors: torch.Tensor) -> None:
    """What every kernel needs: contiguous CUDA tensors of one float32 or
    bfloat16 dtype on one device."""
    t0 = tensors[0]
    for t in tensors:
        if t.device.type != "cuda" or t.device != t0.device:
            raise ValueError(f"{name}: all inputs must be on {t0.device}, "
                             f"got {t.device}")
        if t.dtype not in _DTYPE_CODES or t.dtype != t0.dtype:
            raise TypeError(f"{name}: inputs must share float32 or bfloat16, "
                            f"got {t.dtype} and {t0.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def aligned16(*tensors: torch.Tensor) -> tuple:
    """The kernels load their inputs with cp.async's 16-byte copies: a
    tensor whose data does not start on 16 bytes (a view one element into
    its storage) is copied to one that does."""
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone() for t in tensors)


def recompute_vjp(plain, inputs, needs_grad, g) -> tuple:
    """A kernel's backward: run `plain` on `inputs` again under autograd and
    return its vector-Jacobian product with `g`, None where no gradient is
    needed."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(need)
                  for t, need in zip(inputs, needs_grad)]
        wanted = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad(plain(*leaves), wanted, g))
    return tuple(next(grads) if t.requires_grad else None for t in leaves)


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
