"""SSIM, MS-SSIM and PSNR mirroring the reference's pytorch_msssim package
(counterpart of cfen_vit_tpu/ops/ssim.py), on NCHW.

11x11 gaussian window (sigma 1.5) applied as two separable 11-tap
depthwise convolutions, VALID padding, value-range detection (max > 128 =>
L from 255, min < -0.5 => the range includes -1), C1/C2 with k1 0.01 /
k2 0.03, and the Wang et al. MS-SSIM weights with 2x average pooling
between levels.  The variances E[x^2] - mu^2 are clamped at 0: in bf16 a
near-constant window gives a small negative variance by cancellation,
which can drive the denominator to 0 (an exact-math no-op otherwise).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .resize import avg_pool2


def gaussian_1d(size: int = 11, sigma: float = 1.5, dtype=torch.float32,
                device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-torch.square(x) / (2.0 * sigma ** 2))
    return (g / g.sum()).to(dtype)


def _depthwise_sep(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """VALID separable gaussian per channel: [k] taps down, then across."""
    c, k = x.shape[1], g.shape[0]
    x = F.conv2d(x, g.view(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    return F.conv2d(x, g.view(1, 1, 1, k).expand(c, 1, 1, k), groups=c)


def ssim(img1, img2, window_size: int = 11, val_range=None,
         full: bool = False):
    """Mean SSIM over the batch (the reference's size_average=True)."""
    if val_range is None:
        max_val = torch.where(img1.max() > 128, 255.0, 1.0)
        min_val = torch.where(img1.min() < -0.5, -1.0, 0.0)
        L = max_val - min_val
    else:
        L = val_range
    h, w = img1.shape[2:]
    g = gaussian_1d(min(window_size, h, w), dtype=img1.dtype,
                    device=img1.device)
    mu1 = _depthwise_sep(img1, g)
    mu2 = _depthwise_sep(img2, g)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = (_depthwise_sep(img1 * img1, g) - mu1_sq).clamp_min(0.0)
    sigma2_sq = (_depthwise_sep(img2 * img2, g) - mu2_sq).clamp_min(0.0)
    sigma12 = _depthwise_sep(img1 * img2, g) - mu1_mu2

    C1 = (0.01 * L) ** 2
    C2 = (0.03 * L) ** 2
    v1 = 2.0 * sigma12 + C2
    v2 = sigma1_sq + sigma2_sq + C2
    cs = torch.mean(v1 / v2)
    ssim_map = ((2 * mu1_mu2 + C1) * v1) / ((mu1_sq + mu2_sq + C1) * v2)
    ret = torch.mean(ssim_map)
    if full:
        return ret, cs
    return ret


def msssim(img1, img2, window_size: int = 11, val_range=None):
    weights = torch.tensor([0.0448, 0.2856, 0.3001, 0.2363, 0.1333],
                           dtype=img1.dtype, device=img1.device)
    ssims, mcs = [], []
    for _ in range(5):
        sim, cs = ssim(img1, img2, window_size=window_size,
                       val_range=val_range, full=True)
        ssims.append(sim)
        mcs.append(cs)
        img1 = avg_pool2(img1)
        img2 = avg_pool2(img2)
    pow1 = torch.stack(mcs) ** weights
    pow2 = torch.stack(ssims) ** weights
    return torch.prod(pow1[:-1]) * pow2[-1]


def psnr(img1, img2, data_range: float = 2.0):
    """PSNR over the [-1,1] convention by default (data_range=2)."""
    mse = torch.mean(torch.square(img1 - img2))
    return 10.0 * torch.log10(data_range ** 2 / mse.clamp_min(1e-12))
