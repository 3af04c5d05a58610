"""Builds the CUDA kernels in csrc/ and binds them with ctypes.

On first use, `library()` compiles every `csrc/*.cu` with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

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
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# entry point -> argtypes (pointers, ints, dtype code, stream)
_SIGNATURES = {
    "cfen_attn_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "cfen_tail_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "cfen_stem_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                      _I, _P],
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
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    lib.with_suffix(".log").write_text(" ".join(cmd) + "\n" + res.stdout
                                       + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, lib)
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
    bfloat16 dtype on one device, with no autograd to record (the kernels
    are forward only)."""
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
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the CUDA kernel is forward only; run it "
                           "under torch.no_grad() or inference_mode()")


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
