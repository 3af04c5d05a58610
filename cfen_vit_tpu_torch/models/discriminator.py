"""PatchGAN discriminators (counterpart of
cfen_vit_tpu/models/discriminator.py; ref models/networks.py:495-566,
define_D :84-98), NCHW, with the reference's state_dict keys.

NLayerDiscriminator ('basic', or 'n_layers' with --n_layers_D): 4x4 convs
with zero padding 1, stride 2 for the first n_layers, then two of stride
1 down to one logit map; InstanceNorm without affine (the port's float32
one-pass statistics) after every conv but the first and last, LeakyReLU
0.2 between, and a sigmoid only under --no_lsgan.  The conditional input
is cat(hazy, image), 6 channels.

PixelDiscriminator ('pixel'): a 1x1 conv stack.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..ops.nn import instance_norm


class InstanceNorm(nn.Module):
    """InstanceNorm2d(affine=False) with float32 statistics (ops/nn.py)."""

    def forward(self, x):
        return instance_norm(x)


def nlayer_discriminator(input_nc: int, ndf: int = 64, n_layers: int = 3,
                         use_sigmoid: bool = False) -> nn.Sequential:
    def block(cin, cout, stride, norm):
        return ([nn.Conv2d(cin, cout, 4, stride, 1)]
                + ([InstanceNorm()] if norm else [])
                + [nn.LeakyReLU(0.2)])

    seq = block(input_nc, ndf, 2, False)
    mult = 1
    for n in range(1, n_layers):
        prev, mult = mult, min(2 ** n, 8)
        seq += block(ndf * prev, ndf * mult, 2, True)
    prev, mult = mult, min(2 ** n_layers, 8)
    seq += block(ndf * prev, ndf * mult, 1, True)
    seq += [nn.Conv2d(ndf * mult, 1, 4, 1, 1)]
    if use_sigmoid:
        seq += [nn.Sigmoid()]
    return nn.Sequential(*seq)


def pixel_discriminator(input_nc: int, ndf: int = 64,
                        use_sigmoid: bool = False) -> nn.Sequential:
    seq = [nn.Conv2d(input_nc, ndf, 1), nn.LeakyReLU(0.2),
           nn.Conv2d(ndf, ndf * 2, 1), InstanceNorm(), nn.LeakyReLU(0.2),
           nn.Conv2d(ndf * 2, 1, 1)]
    if use_sigmoid:
        seq += [nn.Sigmoid()]
    return nn.Sequential(*seq)


class Discriminator(nn.Module):
    """Holds the reference's Sequential under its attribute name (`model`
    for NLayer, `net` for Pixel), so the state_dict keys match."""

    def __init__(self, cfg):
        super().__init__()
        input_nc, use_sigmoid = cfg.input_nc * 2, cfg.no_lsgan
        kind = cfg.which_model_netD
        if kind in ("basic", "n_layers"):
            n = 3 if kind == "basic" else cfg.n_layers_D
            self.model = nlayer_discriminator(input_nc, cfg.ndf, n, use_sigmoid)
        elif kind == "pixel":
            self.net = pixel_discriminator(input_nc, cfg.ndf, use_sigmoid)
        else:
            raise NotImplementedError(
                f"Discriminator model name [{kind}] is not recognized")

    def forward(self, x):
        return (self.model if hasattr(self, "model") else self.net)(x)


@torch.no_grad()
def define_d(cfg, gen: torch.Generator) -> Discriminator:
    """A discriminator with the JAX conv_init distributions: kaiming-normal
    (fan_in) weights from `gen`, zero biases."""
    d = Discriminator(cfg)
    for m in d.modules():
        if isinstance(m, nn.Conv2d):
            m.weight.normal_(0.0, math.sqrt(2.0 / m.weight[0].numel()),
                             generator=gen)
            m.bias.zero_()
    return d


def apply_d(d: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return d(x)
