"""The controls of `correct`: the reference computed one precision below
the one the configuration states, by rounding the operands of every
convolution and matrix product (its weights and its activations) as
that precision's tensor-core path would take them, with float32
accumulation:

  "tf32"  (for float32 without TF32): round to nearest at TF32's 10-bit
          mantissa, what cuDNN and cuBLAS do with allow_tf32 on;
  "fp8"   (for bfloat16): float8 e4m3 with one scale per tensor
          (amax / 448), the usual fp8 inference and training recipe.

The rounding is a straight-through one (x + (q(x) - x).detach()), so the
backward sees the rounded forward and passes its cotangents on.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

_PRODUCTS = {F.conv2d, F.conv_transpose2d, F.linear, torch.matmul, torch.bmm,
             torch.Tensor.__matmul__, torch.conv2d, torch.conv_transpose2d}


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32).to(x.dtype)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().float().clamp_min(1e-12) / 448.0
    return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)


ROUNDERS = {"tf32": round_tf32, "fp8": round_fp8}


class LowPrecision(TorchFunctionMode):
    """Inside the block every product's floating operands are rounded by
    `ROUNDERS[kind]`."""

    def __init__(self, kind: str):
        super().__init__()
        self.round = ROUNDERS[kind]

    def _q(self, a):
        if isinstance(a, torch.Tensor) and a.is_floating_point():
            return a + (self.round(a.detach()) - a.detach())
        return a

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            args = tuple(self._q(a) for a in args)
            kwargs = {k: self._q(v) for k, v in kwargs.items()}
        return func(*args, **kwargs)
