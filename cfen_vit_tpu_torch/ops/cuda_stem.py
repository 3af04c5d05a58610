"""K4: the stem, head conv5x5 3 -> cm plus the ResBlock
h + conv3x3(relu(conv3x3(h))), at full resolution (counterpart of
cfen_vit_tpu/ops/pallas_stem.py).

Replaces the TPU kernel `fused_stem` (pallas_stem.py, kernel `_kstem`)
with csrc/stem.cu.  On Hopper the plain version is bound by device memory
(two cm-channel full-resolution intermediates written and reread); the
kernel keeps h and the relu output channel-last in shared memory per tile,
zero outside the image as the zero-padded convolutions require, and runs
the two 3x3 convolutions as implicit GEMMs on the tensor cores (bf16
directly, float32 as 3xTF32) and the 5x5 head as FFMA summed in the plain
version's order (so h matches it bit for bit), at any stem width cm up to
MAX_STEM_WIDTH (`takes`).  See the source's header.

`fused_stem` runs `stem_plain` (JAX models/generator.py _stem_plain) for
CPU tensors and the kernel for CUDA tensors; a CUDA input the kernel does
not take raises.  Under autograd the kernel's backward recomputes through
`stem_plain` and returns its vector-Jacobian product, as the JAX package's
custom VJP does (generator.py _stem_fused_bwd).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

launches = 0          # kernel launches since the last reset
recomputes = 0        # backward recomputes through stem_plain
MAX_STEM_WIDTH = 146   # csrc/stem.cu stem_plan: every cm up to it has a tile


def takes(cin: int, cm: int) -> bool:
    """Whether the kernel takes an RGB input into a stem of cm channels."""
    return cin == 3 and 1 <= cm <= MAX_STEM_WIDTH


def plan(cm: int, dtype: torch.dtype) -> tuple:
    """The kernel's launch geometry for cm channels (csrc/stem.cu
    stem_plan, on the card only): (tile rows, tile cols, n8 tiles an N
    chunk, shared-memory bytes)."""
    out = (ctypes.c_int * 4)()
    rc = _build.library().cfen_stem_plan(
        cm, _build.dtype_code(torch.empty((), dtype=dtype)), out)
    _build.check(rc, "cfen_stem_plan")
    return tuple(out)


def stem_plain(x, w5, b5, w1, b1, w2, b2):
    """x [B,3,H,W] -> [B,cm,H,W]; w5 [cm,3,5,5], w1/w2 [cm,cm,3,3]."""
    h = F.conv2d(x, w5, b5, padding=2)
    return h + F.conv2d(F.relu(F.conv2d(h, w1, b1, padding=1)), w2, b2,
                        padding=1)


def fused_stem(x, w5, b5, w1, b1, w2, b2):
    if x.device.type == "cpu":
        return stem_plain(x, w5, b5, w1, b1, w2, b2)
    return _Stem.apply(x, w5, b5, w1, b1, w2, b2)


class _Stem(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        return _launch(*args)

    @staticmethod
    def backward(ctx, g):
        global recomputes
        recomputes += 1
        return _build.recompute_vjp(stem_plain, ctx.saved_tensors,
                                    ctx.needs_input_grad, g)


def _launch(x, w5, b5, w1, b1, w2, b2):
    global launches
    _build.check_cuda_inputs("fused_stem", x, w5, b5, w1, b1, w2, b2)
    bsz, cin, h, wd = x.shape
    cm = w5.shape[0]
    shapes = [tuple(t.shape) for t in (w5, b5, w1, b1, w2, b2)]
    if not takes(cin, cm) or shapes != [(cm, 3, 5, 5), (cm,), (cm, cm, 3, 3),
                                        (cm,), (cm, cm, 3, 3), (cm,)]:
        raise ValueError(f"fused_stem: takes x [B,3,H,W] and 1 to "
                         f"{MAX_STEM_WIDTH} stem channels, got x {tuple(x.shape)} "
                         f"and {shapes}")
    out = torch.empty((bsz, cm, h, wd), device=x.device, dtype=x.dtype)
    with torch.cuda.device(x.device):
        rc = _build.library().cfen_stem_fwd(
            x.data_ptr(), w5.data_ptr(), b5.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            bsz, cin, cm, h, wd, _build.dtype_code(x), _build.stream(x))
    _build.check(rc, "cfen_stem_fwd")
    launches += 1
    return out
