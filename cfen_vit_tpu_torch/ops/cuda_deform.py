"""K6: the modulated deformable convolution (DCNv2) forward (counterpart of
cfen_vit_tpu/ops/pallas_deform.py).

Replaces the TPU kernel `modulated_deform_conv_pallas` (pallas_deform.py,
kernel `_kernel`) with csrc/deform.cu: the bilinear im2col form as an
implicit GEMM on the tensor cores, gathering natively, with neither the
TPU kernel's window nor its clamp of the displacements.  The kernel takes
scratch for x in channel-last order, the weights repacked K-major and,
above 512 output channels, the sampled patches (`scratch_elems`).  See the source's header for what bounds it on the
card.

`ops/deform_conv.modulated_deform_conv` calls `deform_conv_cuda` for CUDA
tensors; a CUDA input the kernel does not take raises.  Under autograd the
backward recomputes through `deform_plain` and returns its vector-Jacobian
product for all five inputs (x, offset, mask, w, b).  That is what the
JAX package does: it has no backward kernel for K6, its backward is the
closed form `_mdc_bwd` (ops/deform_conv.py), equal to autodiff of the
sampler.
"""

from __future__ import annotations

import torch

from . import _build
from .deform_conv import deform_plain, out_size

launches = 0          # kernel launches since the last reset
recomputes = 0        # backward recomputes through deform_plain


def deform_conv_cuda(x, offset, mask, w, b=None, stride: int = 1, pad: int = 1,
                     dilation: int = 1) -> torch.Tensor:
    return _Deform.apply(x, offset, mask, w, b, stride, pad, dilation)


class _Deform(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, offset, mask, w, b, stride, pad, dilation):
        ctx.geometry = (stride, pad, dilation)
        ctx.save_for_backward(x, offset, mask, w, b)
        return _launch(x, offset, mask, w, b, stride, pad, dilation)

    @staticmethod
    def backward(ctx, g):
        global recomputes
        recomputes += 1
        stride, pad, dilation = ctx.geometry
        x, offset, mask, w, b = ctx.saved_tensors
        needs = ctx.needs_input_grad[:5]
        if b is None:
            grads = _build.recompute_vjp(
                lambda *a: deform_plain(*a, None, stride, pad, dilation),
                (x, offset, mask, w), needs[:4], g) + (None,)
        else:
            grads = _build.recompute_vjp(
                lambda *a: deform_plain(*a, stride, pad, dilation),
                (x, offset, mask, w, b), needs, g)
        return grads + (None, None, None)


def scratch_elems(n: int, c: int, h: int, w: int, o: int, k: int, npix: int,
                  dtype: torch.dtype) -> int:
    """The scratch csrc/deform.cu takes: x as [N, H, W, C rounded up to 8]
    and the weights as [O, K^2, C rounded up to kCC = 32], zero-padded;
    above 512 output channels also the patches of every 32-pixel tile of
    the npix output pixels, [N, tiles, K^2, C to 32] (in float32 twice,
    their TF32 hi and lo parts), which the kernel samples once and reads
    back for each further chunk of 512 channels."""
    cp = -(-c // 32) * 32
    patches = 0 if o <= 512 else (
        n * -(-npix // 32) * 32 * k * k * cp * (2 if dtype == torch.float32 else 1))
    return n * h * w * -(-c // 8) * 8 + o * k * k * cp + patches


def _launch(x, offset, mask, w, b, stride, pad, dilation):
    global launches
    tensors = (x, offset, mask, w) + (() if b is None else (b,))
    _build.check_cuda_inputs("modulated_deform_conv", *tensors)
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"modulated_deform_conv: takes x [N,C,H,W] and w "
                         f"[O,C,K,K], got {tuple(x.shape)} and {tuple(w.shape)}")
    n, c, h, wd = x.shape
    o, k = w.shape[0], w.shape[2]
    if (k not in (3, 5) or tuple(w.shape) != (o, c, k, k) or stride < 1
            or dilation < 1 or pad < 0):
        raise ValueError(f"modulated_deform_conv: the kernel takes w [O,C,K,K] "
                         f"with K 3 or 5 and C of x, stride and dilation >= 1, "
                         f"pad >= 0; got w {tuple(w.shape)} for x "
                         f"{tuple(x.shape)}, stride {stride}, pad {pad}, "
                         f"dilation {dilation}")
    oh = out_size(h, k, stride, pad, dilation)
    ow = out_size(wd, k, stride, pad, dilation)
    if (oh < 1 or ow < 1 or n > 65535
            or tuple(offset.shape) != (n, 2 * k * k, oh, ow)
            or tuple(mask.shape) != (n, k * k, oh, ow)
            or (b is not None and tuple(b.shape) != (o,))):
        raise ValueError(f"modulated_deform_conv: expected offset "
                         f"[{n},{2 * k * k},{oh},{ow}], mask [{n},{k * k},{oh},"
                         f"{ow}] and b [{o}], got {tuple(offset.shape)}, "
                         f"{tuple(mask.shape)} and "
                         f"{None if b is None else tuple(b.shape)}")
    out = torch.empty((n, o, oh, ow), device=x.device, dtype=x.dtype)
    scratch = torch.empty(scratch_elems(n, c, h, wd, o, k, oh * ow, x.dtype),
                          device=x.device, dtype=x.dtype)
    with torch.cuda.device(x.device):
        rc = _build.library().cfen_deform_fwd(
            x.data_ptr(), offset.data_ptr(), mask.data_ptr(), w.data_ptr(),
            None if b is None else b.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), n, c, h, wd, o, k, oh, ow, stride, pad,
            dilation, _build.dtype_code(x), _build.stream(x))
    _build.check(rc, "cfen_deform_fwd")
    launches += 1
    return out
