"""Deformable convolution v1/v2 (counterpart of cfen_vit_tpu/ops/deform_conv.py),
in NCHW like the rest of the port.

Layouts: x [N,C,H,W]; offset [N,2K²,OH,OW] with JAX's channel order (ky,
kx, [dy, dx]): channel 2t is dy of tap t = ky*K + kx and 2t+1 is dx; mask
[N,K²,OH,OW] (post-sigmoid); w [O,C,K,K], the reference state_dict layout.

The sampling coordinate of output (oy, ox), tap (ky, kx) is

    y = oy*stride - pad + ky*dilation + dy,   x likewise,

formed in float32 whatever the inputs' dtype.  The JAX XLA path forms it
in x.dtype, which in bf16 loses the fractional part at coordinates >= 128
(ROADMAP Queue C); the TPU kernel forms it in float32, as here.  A
bilinear neighbour outside [0,H-1]x[0,W-1] reads 0; the in-bounds
neighbours of a partly outside sample still count.  No displacement is
clamped (the TPU kernel clamps to |d| <= 12; this is the exact function it
approximates).

`modulated_deform_conv` runs `deform_plain` on CPU tensors and K6
(ops/cuda_deform.py, csrc/deform.cu) on CUDA tensors.
"""

from __future__ import annotations

import torch
import torch.nn as nn


def out_size(size: int, kernel: int, stride: int, pad: int,
             dilation: int) -> int:
    return (size + 2 * pad - (dilation * (kernel - 1) + 1)) // stride + 1


def sample_patches(x: torch.Tensor, offset: torch.Tensor, kernel: int,
                   stride: int = 1, pad: int = 1,
                   dilation: int = 1) -> torch.Tensor:
    """Bilinear samples of the K² deformed taps of every output pixel, in
    float32: x [N,C,H,W], offset [N,2K²,OH,OW] -> [N,OH,OW,K²,C] (the JAX
    sampler's layout).  Linear in x for a fixed offset."""
    n, c, h, w = x.shape
    k = kernel
    oh = out_size(h, k, stride, pad, dilation)
    ow = out_size(w, k, stride, pad, dilation)
    dev = x.device
    off = offset.float().reshape(n, k * k, 2, oh, ow).permute(0, 3, 4, 1, 2)
    taps = torch.arange(k, device=dev)
    ky = taps.repeat_interleave(k)
    kx = taps.repeat(k)
    # integer base grid [OH,OW,K²], exact in float32, plus the offsets
    by = (torch.arange(oh, device=dev)[:, None, None] * stride - pad
          + ky * dilation).float()
    bx = (torch.arange(ow, device=dev)[None, :, None] * stride - pad
          + kx * dilation).float()
    ys = by + off[..., 0]                       # [N,OH,OW,K²]
    xs = bx + off[..., 1]
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    fy = (ys - y0)[..., None]
    fx = (xs - x0)[..., None]

    rows = x.float().permute(0, 2, 3, 1).reshape(n, h * w, c)
    batch = torch.arange(n, device=dev)[:, None]

    def at(yi, xi):
        valid = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
        idx = (yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long())
        g = rows[batch, idx.reshape(n, -1)].reshape(n, oh, ow, k * k, c)
        return g * valid[..., None].float()

    v00 = at(y0, x0)
    v01 = at(y0, x0 + 1)
    v10 = at(y0 + 1, x0)
    v11 = at(y0 + 1, x0 + 1)
    return ((1 - fy) * (1 - fx) * v00 + (1 - fy) * fx * v01
            + fy * (1 - fx) * v10 + fy * fx * v11)


def deform_plain(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                 w: torch.Tensor, b: torch.Tensor | None = None,
                 stride: int = 1, pad: int = 1,
                 dilation: int = 1) -> torch.Tensor:
    """DCNv2 forward, the plain version of K6: samples in float32, times the
    mask, rounded to x.dtype (the TPU kernel's rounding point); the product
    with w summed in float32 and rounded to x.dtype; the bias added in
    x.dtype.  -> [N,O,OH,OW]."""
    o, c, k, _ = w.shape
    n, _, oh, ow = mask.shape
    patches = sample_patches(x, offset, k, stride, pad, dilation)
    m = mask.float().permute(0, 2, 3, 1)[..., None]          # [N,OH,OW,K²,1]
    patches = (patches * m).to(x.dtype).float()
    out = torch.einsum("nhwkc,ock->nohw", patches,
                       w.float().reshape(o, c, k * k)).to(x.dtype)
    if b is not None:
        out = out + b.reshape(1, o, 1, 1)
    return out


def modulated_deform_conv(x: torch.Tensor, offset: torch.Tensor,
                          mask: torch.Tensor, w: torch.Tensor,
                          b: torch.Tensor | None = None, stride: int = 1,
                          pad: int = 1, dilation: int = 1) -> torch.Tensor:
    """ModulatedDeformConv (DCNv2): `deform_plain` for CPU tensors, K6 for
    CUDA tensors (a CUDA input the kernel does not take raises)."""
    if x.device.type == "cpu":
        return deform_plain(x, offset, mask, w, b, stride, pad, dilation)
    from .cuda_deform import deform_conv_cuda
    return deform_conv_cuda(x, offset, mask, w, b, stride, pad, dilation)


def deform_conv(x: torch.Tensor, offset: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor | None = None, stride: int = 1, pad: int = 1,
                dilation: int = 1) -> torch.Tensor:
    """DeformConv (DCNv1): the mask == 1 case."""
    k2 = w.shape[2] * w.shape[3]
    mask = torch.ones((offset.shape[0], k2) + tuple(offset.shape[2:]),
                      dtype=x.dtype, device=x.device)
    return modulated_deform_conv(x, offset, mask, w, b, stride, pad, dilation)


class ModulatedDeformConvPack(nn.Module):
    """DCNv2 'Pack' (JAX modulated_deform_conv_pack_init/apply): offsets and
    mask predicted from the input by `conv_offset_mask`, a plain conv that
    starts at zero, so the Pack starts as a plain conv scaled by
    sigmoid(0)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1,
                 dilation: int = 1):
        super().__init__()
        k = kernel_size
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, k, k))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        nn.init.kaiming_normal_(self.weight)        # std sqrt(2 / (C K²))
        self.conv_offset_mask = nn.Conv2d(in_channels, 3 * k * k, k,
                                          stride=stride, padding=padding)
        nn.init.zeros_(self.conv_offset_mask.weight)
        nn.init.zeros_(self.conv_offset_mask.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        om = self.conv_offset_mask(x)
        o1, o2, m = torch.chunk(om, 3, dim=1)
        # (dy, dx) interleaved per tap: o1 holds the dys, o2 the dxs
        offset = torch.stack([o1, o2], dim=2).reshape(
            om.shape[0], 2 * o1.shape[1], om.shape[2], om.shape[3])
        return modulated_deform_conv(x, offset, torch.sigmoid(m), self.weight,
                                     self.bias, self.stride, self.padding,
                                     self.dilation)

