"""Frozen plain reference of the GAN losses (a copy of the port's
losses/vgg.py, losses/gan.py, ops/ssim.py, ops/gradient.py and the dense
ID-MRF of ops/cuda_mrf.py), float32, NCHW.

`remat` in `idmrf` recomputes each q-block of the ID-MRF's [N, b, P]
slab in the backward (torch.utils.checkpoint) so that the reference fits
beside nothing else on the card; the FLOP count runs it without, so
that it counts model operations and not the recompute.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

VGG19_BLOCKS = ((64, 2), (128, 2), (256, 4), (512, 4), (512, 4))
IMAGENET_MEAN = (0.485, 0.456, 0.406)
PERCEPTUAL = (("relu1_1", 1 / 32), ("relu2_1", 1 / 16), ("relu3_1", 1 / 8),
              ("relu4_1", 1 / 4), ("relu5_1", 1.0))
MRF_EPS = 1e-5


class VGG19(nn.Module):
    """VGG19's convolutions through conv5_1, named conv{block}_{i}."""

    def __init__(self):
        super().__init__()
        cin = 3
        for bi, (ch, n) in enumerate(VGG19_BLOCKS, start=1):
            for ci in range(1, n + 1):
                self.add_module(f"conv{bi}_{ci}", nn.Conv2d(cin, ch, 3, padding=1))
                cin = ch


def vgg_features(vgg, x, taps, subtract_mean=False):
    if subtract_mean:
        x = x - torch.tensor(IMAGENET_MEAN, dtype=x.dtype,
                             device=x.device).view(1, 3, 1, 1)
    want, feats = set(taps), {}
    for bi, (_, n) in enumerate(VGG19_BLOCKS, start=1):
        if bi > 1:
            x = F.max_pool2d(x, 2)
        for ci in range(1, n + 1):
            x = F.relu(getattr(vgg, f"conv{bi}_{ci}")(x))
            if f"relu{bi}_{ci}" in want:
                feats[f"relu{bi}_{ci}"] = x
                if len(feats) == len(want):
                    return feats
    return feats


def perceptual(vgg, x, y):
    taps = tuple(t for t, _ in PERCEPTUAL)
    fx = vgg_features(vgg, x, taps)
    with torch.no_grad():
        fy = vgg_features(vgg, y, taps)
    return sum(w * torch.mean(torch.abs(fx[t] - fy[t])) for t, w in PERCEPTUAL)


def semantic(vgg, out, target):
    fo = vgg_features(vgg, out, ("relu3_1",), subtract_mean=True)
    ft = vgg_features(vgg, target, ("relu3_1",), subtract_mean=True)
    return torch.mean(torch.abs(fo["relu3_1"] - ft["relu3_1"]))


def _normalize(o, t):
    n, c, h, w = o.shape
    t_mean = t.mean(dim=1, keepdim=True)
    o_f, t_f = o - t_mean, t - t_mean
    o_n = o_f / torch.linalg.vector_norm(o_f, dim=1, keepdim=True)
    t_n = t_f / torch.linalg.vector_norm(t_f, dim=1, keepdim=True)
    return (o_n.reshape(n, c, h * w).transpose(1, 2),
            t_n.reshape(n, c, h * w).transpose(1, 2))


def _block_colmax(o_rows, t_n):
    cos = o_rows @ t_n.transpose(1, 2)
    cdist = (-(cos - 1.0) / 2.0).clamp_min(0.0)
    rel = cdist / (cdist.amin(dim=2, keepdim=True) + MRF_EPS)
    before = torch.exp((1.0 - rel) / 0.5)
    return (before / before.sum(dim=2, keepdim=True)).amax(dim=1)


def mrf(o, t, remat=True, block=2048):
    """sum_n -log(mean_p max_q cs[q, p]) of one layer, q-blocked."""
    o_n, t_n = _normalize(o, t)
    kmax = None
    for q0 in range(0, o_n.shape[1], block):
        rows = o_n[:, q0:q0 + block]
        bmax = (checkpoint(_block_colmax, rows, t_n, use_reentrant=False)
                if remat else _block_colmax(rows, t_n))
        kmax = bmax if kmax is None else torch.maximum(kmax, bmax)
    return (-torch.log(kmax.mean(dim=1))).sum()


def idmrf(vgg, out, target, remat=True):
    """relu3_1 + 2 relu4_1, ImageNet mean subtracted; `target` supplies
    the mean shift and the patch bank."""
    taps = ("relu3_1", "relu4_1")
    fo = vgg_features(vgg, out, taps, subtract_mean=True)
    ft = vgg_features(vgg, target, taps, subtract_mean=True)
    return (mrf(fo["relu3_1"], ft["relu3_1"], remat)
            + 2.0 * mrf(fo["relu4_1"], ft["relu4_1"], remat))


def color_gradient(x):
    xp = F.pad(x, (2, 2, 2, 2))
    gv = xp[:, :, 2:, 1:-1] - xp[:, :, :-2, 1:-1]
    gh = xp[:, :, 1:-1, 2:] - xp[:, :, 1:-1, :-2]
    return torch.sqrt(gv * gv + gh * gh + 1e-6)


def _sep(x, g):
    c, k = x.shape[1], g.shape[0]
    x = F.conv2d(x, g.view(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    return F.conv2d(x, g.view(1, 1, 1, k).expand(c, 1, 1, k), groups=c)


def ssim(img1, img2, window_size=11):
    """pytorch_msssim's ssim, size_average, value range from img1."""
    max_val = torch.where(img1.max() > 128, 255.0, 1.0)
    min_val = torch.where(img1.min() < -0.5, -1.0, 0.0)
    L = max_val - min_val
    k = min(window_size, *img1.shape[2:])
    x = torch.arange(k, dtype=torch.float32, device=img1.device) - k // 2
    g = torch.exp(-torch.square(x) / (2.0 * 1.5 ** 2))
    g = (g / g.sum()).to(img1.dtype)
    mu1, mu2 = _sep(img1, g), _sep(img2, g)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = (_sep(img1 * img1, g) - mu1_sq).clamp_min(0.0)
    s2 = (_sep(img2 * img2, g) - mu2_sq).clamp_min(0.0)
    s12 = _sep(img1 * img2, g) - mu1_mu2
    C1, C2 = (0.01 * L) ** 2, (0.03 * L) ** 2
    v1, v2 = 2.0 * s12 + C2, s1 + s2 + C2
    return torch.mean(((2 * mu1_mu2 + C1) * v1) / ((mu1_sq + mu2_sq + C1) * v2))


def lsgan(pred, real: bool):
    return torch.mean(torch.square(pred - (1.0 if real else 0.0)))
