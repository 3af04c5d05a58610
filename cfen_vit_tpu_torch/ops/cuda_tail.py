"""K3: the tail epilogue, tanh(conv7x7(reflect_pad(t2, 3)) + bias) at full
resolution (counterpart of cfen_vit_tpu/ops/pallas_tail.py).

Replaces the TPU kernel `conv7_tail_epilogue` (pallas_tail.py, kernel
`_k2cf`) with csrc/tail.cu.  In bf16 the kernel is an implicit GEMM on the
tensor cores (output pixels x (tap, channel) x out_c padded to 8), its
input staged channel-last with the reflect index computed at staging, so
no padded copy is made; in float32 a register-blocked FFMA loop (the
count in the source's header chooses it over 3xTF32).  Both take the
channels in chunks, so any c fits.  See the source's header.

`tail_epilogue` runs `tail_plain` (JAX models/generator.py
_tail_epilogue_plain) for CPU tensors and the kernel for CUDA tensors; a
CUDA input the kernel does not take raises (`takes` is the shape rule).
Under autograd the kernel's backward recomputes through `tail_plain` and
returns its vector-Jacobian product, as the JAX package's custom VJP does
(generator.py _tail_epilogue_bwd).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

launches = 0          # kernel launches since the last reset
recomputes = 0        # backward recomputes through tail_plain


def takes(cin: int, out_c: int, h: int, w: int) -> bool:
    """Whether the kernel takes t2 [B, cin, h, w] into out_c channels: any
    cin, out_c 1 or 3, and sides the reflect padding by 3 allows."""
    return cin >= 1 and out_c in (1, 3) and min(h, w) >= 4


def tail_plain(t2: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """t2 [B,C,H,W], w [out_c,C,7,7], b [out_c] -> [B,out_c,H,W]."""
    return torch.tanh(F.conv2d(F.pad(t2, (3, 3, 3, 3), mode="reflect"), w, b))


def tail_epilogue(t2: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    if t2.device.type == "cpu":
        return tail_plain(t2, w, b)
    return _Tail.apply(t2, w, b)


class _Tail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t2, w, b):
        ctx.save_for_backward(t2, w, b)
        return _launch(t2, w, b)

    @staticmethod
    def backward(ctx, g):
        global recomputes
        recomputes += 1
        return _build.recompute_vjp(tail_plain, ctx.saved_tensors,
                                    ctx.needs_input_grad, g)


def _launch(t2, w, b):
    global launches
    _build.check_cuda_inputs("tail_epilogue", t2, w, b)
    bsz, cin, h, wd = t2.shape
    out_c = w.shape[0]
    if (tuple(w.shape) != (out_c, cin, 7, 7) or tuple(b.shape) != (out_c,)
            or not takes(cin, out_c, h, wd)):
        raise ValueError(f"tail_epilogue: takes t2 [B,C,H,W] with H, W >= 4 "
                         f"and w [1 or 3,C,7,7], got {tuple(t2.shape)} and "
                         f"{tuple(w.shape)}")
    out = torch.empty((bsz, out_c, h, wd), device=t2.device, dtype=t2.dtype)
    with torch.cuda.device(t2.device):
        rc = _build.library().cfen_tail_fwd(
            t2.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
            bsz, cin, h, wd, out_c, _build.dtype_code(t2), _build.stream(t2))
    _build.check(rc, "cfen_tail_fwd")
    launches += 1
    return out
