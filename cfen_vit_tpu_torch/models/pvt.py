"""Pyramid Vision Transformer backbone (counterpart of
cfen_vit_tpu/models/pvt.py; ref models/pvt.py:129-265, which needs timm,
mmseg and mmcv and cannot import there), NCHW in, NCHW out.

Four stages: a strided conv patch embedding (patch_size, then 2), a
LayerNorm, learned positions (resized bilinearly when the map is not
img_size's), then blocks of pre-norm spatial-reduction attention (K and
V from a map downsampled by sr_ratio with a strided conv and a
LayerNorm) and a GELU MLP; LayerNorm eps 1e-6.  `forward` returns the four
maps at /4, /8, /16, /32.  The attention is plain (float32 logits,
softmax, product), as the JAX package's: PVT holds no TPU kernel there.
GELU is its tanh form (jax.nn.gelu's default).  Stochastic depth is left
out, as in JAX (drop rates are 0 in the reference's use).

Presets pvt_tiny/small/medium/large (ref :236-265): embed dims
(64, 128, 320, 512), heads (1, 2, 5, 8), MLP ratios (8, 8, 4, 4), sr
(8, 4, 2, 1), depths (2, 2, 2, 2) to (3, 8, 27, 3).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclass(frozen=True)
class PVTSpec:
    patch_size: int = 4
    in_chans: int = 3
    embed_dims: Tuple[int, ...] = (64, 128, 320, 512)
    num_heads: Tuple[int, ...] = (1, 2, 5, 8)
    mlp_ratios: Tuple[int, ...] = (8, 8, 4, 4)
    depths: Tuple[int, ...] = (2, 2, 2, 2)
    sr_ratios: Tuple[int, ...] = (8, 4, 2, 1)
    img_size: int = 224


PRESETS = {
    "pvt_tiny": PVTSpec(depths=(2, 2, 2, 2)),
    "pvt_small": PVTSpec(depths=(3, 4, 6, 3)),
    "pvt_medium": PVTSpec(depths=(3, 4, 18, 3)),
    "pvt_large": PVTSpec(depths=(3, 8, 27, 3)),
}


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int):
        super().__init__()
        self.num_heads, self.sr_ratio = num_heads, sr_ratio
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.sr_norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x, h: int, w: int):
        n, l, c = x.shape
        heads, dh = self.num_heads, c // self.num_heads
        q = self.q(x).reshape(n, l, heads, dh).transpose(1, 2)
        if self.sr_ratio > 1:
            xm = self.sr(x.transpose(1, 2).reshape(n, c, h, w))
            xm = self.sr_norm(xm.flatten(2).transpose(1, 2))
        else:
            xm = x
        kv = self.kv(xm).reshape(n, -1, 2, heads, dh).permute(2, 0, 3, 1, 4)
        k, v = kv[0], kv[1]
        logits = (q.float() @ k.float().transpose(-1, -2)) * dh ** -0.5
        out = logits.softmax(dim=-1).to(v.dtype) @ v
        return self.proj(out.transpose(1, 2).reshape(n, l, c))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int,
                 sr_ratio: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, sr_ratio)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x, h: int, w: int):
        x = x + self.attn(self.norm1(x), h, w)
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x)), approximate="tanh"))


class Stage(nn.Module):
    def __init__(self, cin: int, dim: int, patch: int, size: int,
                 num_heads: int, mlp_ratio: int, sr_ratio: int, depth: int):
        super().__init__()
        self.patch = patch
        self.proj = nn.Conv2d(cin, dim, patch, stride=patch)
        self.embed_norm = nn.LayerNorm(dim, eps=1e-6)
        self.pos = nn.Parameter(torch.zeros(size * size, dim))
        self.blocks = nn.ModuleList(Block(dim, num_heads, mlp_ratio, sr_ratio)
                                    for _ in range(depth))

    def positions(self, h: int, w: int) -> torch.Tensor:
        """[h*w, dim]; jax.image.resize "linear" (half-pixel centres, a
        triangle filter widened when shrinking) when the map is not the
        preset's."""
        pos = self.pos
        if pos.shape[0] == h * w:
            return pos
        side = int(pos.shape[0] ** 0.5)
        grid = pos.float().reshape(1, side, side, -1).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, size=(h, w), mode="bilinear",
                             align_corners=False, antialias=h < side or w < side)
        return grid.permute(0, 2, 3, 1).reshape(h * w, -1).to(pos.dtype)

    def forward(self, x):
        x = self.proj(x)
        n, c, h, w = x.shape
        t = self.embed_norm(x.flatten(2).transpose(1, 2))
        t = t + self.positions(h, w).to(t.dtype)
        for blk in self.blocks:
            t = blk(t, h, w)
        return t.transpose(1, 2).reshape(n, c, h, w)


class PVT(nn.Module):
    def __init__(self, spec: PVTSpec):
        super().__init__()
        self.spec = spec
        stages, cin, size = [], spec.in_chans, spec.img_size
        for i in range(4):
            patch = spec.patch_size if i == 0 else 2
            size //= patch
            stages.append(Stage(cin, spec.embed_dims[i], patch, size,
                                spec.num_heads[i], spec.mlp_ratios[i],
                                spec.sr_ratios[i], spec.depths[i]))
            cin = spec.embed_dims[i]
        self.stages = nn.ModuleList(stages)

    def forward(self, x) -> List[torch.Tensor]:
        outs = []
        for stage in self.stages:
            x = stage(x)
            outs.append(x)
        return outs


@torch.no_grad()
def init_pvt(net: PVT, gen: torch.Generator) -> PVT:
    """The JAX pvt_init distributions: linears and positions truncated
    normal (std 0.02, at 2 std), zero biases, convs kaiming-normal
    (fan_in), LayerNorms 1 and 0."""
    for m in net.modules():
        if isinstance(m, nn.Linear):
            nn.init.trunc_normal_(m.weight, std=0.02, a=-0.04, b=0.04,
                                  generator=gen)
            m.bias.zero_()
        elif isinstance(m, nn.Conv2d):
            m.weight.normal_(0.0, (2.0 / m.weight[0].numel()) ** 0.5,
                             generator=gen)
            m.bias.zero_()
        elif isinstance(m, Stage):
            nn.init.trunc_normal_(m.pos, std=0.02, a=-0.04, b=0.04,
                                  generator=gen)
    return net


def create_pvt(name: str = "pvt_tiny", seed: int = 0, **overrides):
    """(spec, PVT) of a preset, weights drawn from `seed`."""
    spec = replace(PRESETS[name], **overrides)
    return spec, init_pvt(PVT(spec), torch.Generator().manual_seed(seed))
