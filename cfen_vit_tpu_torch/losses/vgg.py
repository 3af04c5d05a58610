"""VGG19 feature tower and the three perceptual losses built on it
(counterpart of cfen_vit_tpu/losses/vgg.py), NCHW.

  * `vgg_perceptual_loss`: the reference's epdn VGGLoss, L1 per slice at
    relu1_1/2_1/3_1/4_1/5_1 with weights [1/32, 1/16, 1/8, 1/4, 1], inputs
    in [-1, 1] without mean shift, the target side without gradient;
  * `semantic_consistency_loss`: L1 on relu3_1, ImageNet mean subtracted;
  * `idmrf_loss`: ID-MRF on relu3_1 + 2 x relu4_1, ImageNet mean
    subtracted; the core runs through ops/cuda_mrf.py (K5 on the card).

Taps name the ReLU after a conv ('relu3_1' follows conv3_1).  Weights come
from `--vgg19_npz` / $CFEN_VGG19_NPZ (keys conv{k}_{i}.w HWIO and .b), or
else a tower seeded from a torch.Generator: a valid random-feature
perceptual loss, not ImageNet's.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import cuda_mrf

# (channels, convs) per block, through conv5_1
_VGG19_BLOCKS = [(64, 2), (128, 2), (256, 4), (512, 4), (512, 4)]
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_PERCEPTUAL = (("relu1_1", 1 / 32), ("relu2_1", 1 / 16), ("relu3_1", 1 / 8),
               ("relu4_1", 1 / 4), ("relu5_1", 1.0))


def _layer_defs():
    defs, cin = [], 3
    for bi, (ch, n) in enumerate(_VGG19_BLOCKS, start=1):
        for ci in range(1, n + 1):
            defs.append((f"conv{bi}_{ci}", cin, ch))
            cin = ch
    return defs


class VGG19(nn.Module):
    """The convolutions of VGG19's features through conv5_1, named
    conv{block}_{i}; 3x3, zero padding 1."""

    def __init__(self):
        super().__init__()
        for name, cin, ch in _layer_defs():
            self.add_module(name, nn.Conv2d(cin, ch, 3, padding=1))


@torch.no_grad()
def vgg19_init(npz_path: Optional[str] = None,
               gen: Optional[torch.Generator] = None) -> VGG19:
    """Pretrained weights from the .npz if it exists, else seeded random
    (kaiming-normal fan_in, zero biases); frozen either way."""
    vgg = VGG19()
    npz_path = npz_path or os.environ.get("CFEN_VGG19_NPZ", "")
    if npz_path and os.path.exists(npz_path):
        from ..interop.from_jax import vgg_state_dict_from_jax
        with np.load(npz_path) as data:
            tree = {name: {"w": data[f"{name}.w"], "b": data[f"{name}.b"]}
                    for name, _, _ in _layer_defs()}
        vgg.load_state_dict(vgg_state_dict_from_jax(tree), strict=True)
    else:
        gen = gen if gen is not None else torch.Generator().manual_seed(1234)
        for conv in vgg.children():
            conv.weight.normal_(0.0, math.sqrt(2.0 / conv.weight[0].numel()),
                                generator=gen)
            conv.bias.zero_()
    return vgg.requires_grad_(False)


def vgg19_features(vgg: nn.Module, x: torch.Tensor, taps: Tuple[str, ...],
                   subtract_mean: bool = False) -> Dict[str, torch.Tensor]:
    """x: NCHW.  Runs only as deep as the deepest requested tap."""
    if subtract_mean:
        x = x - torch.tensor(_IMAGENET_MEAN, dtype=x.dtype,
                             device=x.device).view(1, 3, 1, 1)
    want, feats = set(taps), {}
    for bi, (_, n) in enumerate(_VGG19_BLOCKS, start=1):
        if bi > 1:
            x = F.max_pool2d(x, 2)
        for ci in range(1, n + 1):
            x = F.relu(getattr(vgg, f"conv{bi}_{ci}")(x))
            if f"relu{bi}_{ci}" in want:
                feats[f"relu{bi}_{ci}"] = x
                if len(feats) == len(want):
                    return feats
    return feats


def vgg_perceptual_loss(vgg, x, y):
    """epdn VGGLoss: sliced L1 with pyramid weights, y without gradient."""
    taps = tuple(t for t, _ in _PERCEPTUAL)
    fx = vgg19_features(vgg, x, taps)
    with torch.no_grad():
        fy = vgg19_features(vgg, y, taps)
    return sum(w * torch.mean(torch.abs(fx[t] - fy[t])) for t, w in _PERCEPTUAL)


def semantic_consistency_loss(vgg, out, target):
    """L1 on relu3_1 of mean-shifted inputs (ref consistency.py:9-27)."""
    fo = vgg19_features(vgg, out, ("relu3_1",), subtract_mean=True)
    ft = vgg19_features(vgg, target, ("relu3_1",), subtract_mean=True)
    return torch.mean(torch.abs(fo["relu3_1"] - ft["relu3_1"]))


def _normalize_feats(o, t):
    """Centre both maps on t's channel mean and L2-normalise every
    position: [N, C, H, W] -> [N, H*W, C]."""
    n, c, h, w = o.shape
    t_mean = t.mean(dim=1, keepdim=True)
    o_f, t_f = o - t_mean, t - t_mean
    o_n = o_f / torch.linalg.vector_norm(o_f, dim=1, keepdim=True)
    t_n = t_f / torch.linalg.vector_norm(t_f, dim=1, keepdim=True)
    return (o_n.reshape(n, c, h * w).transpose(1, 2).contiguous(),
            t_n.reshape(n, c, h * w).transpose(1, 2).contiguous())


def _mrf(o, t):
    """One-layer ID-MRF divergence (ref consistency.py:42-91); the [P, P]
    relative-distance matrix never exists (ops/cuda_mrf.py)."""
    return cuda_mrf.mrf_core(*_normalize_feats(o, t))


def idmrf_loss(vgg, out, target):
    """style{relu3_2: 1, relu4_2: 1} + content{relu4_2: 1} of the reference
    (ref :30-102), in this tap naming relu3_1 + 2 relu4_1.  Asymmetric:
    `target` supplies the mean shift and the patch bank."""
    taps = ("relu3_1", "relu4_1")
    fo = vgg19_features(vgg, out, taps, subtract_mean=True)
    ft = vgg19_features(vgg, target, taps, subtract_mean=True)
    return _mrf(fo["relu3_1"], ft["relu3_1"]) + 2.0 * _mrf(fo["relu4_1"],
                                                          ft["relu4_1"])
