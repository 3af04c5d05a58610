"""The reference's alternate networks that no trainer, CLI or spec calls
(counterpart of cfen_vit_tpu/models/networks_alt.py; ref
models/networks.py:145-305, 567-601): ResnetGenerator, UnetGenerator and
Classifier, NCHW, with the reference's state_dict keys.

All use InstanceNorm2d, hence biased convs (the reference's use_bias for
that norm): affine=False (ops/nn.py InstanceNorm, float32 statistics) in
the generators, affine=True in the Classifier.  None holds a TPU kernel
in the JAX package, so none has a CUDA kernel here.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.nn import InstanceNorm, instance_norm
from .epdn import GlobalGenerator


class ResnetGenerator(GlobalGenerator):
    """CycleGAN's ResnetGenerator (ref networks.py:145-237): c7s1-ngf, two
    stride-2 downsamplings, n_blocks reflect-padded ResnetBlocks, two
    upsamplings, c7s1-output_nc and tanh: pix2pixHD's GlobalGenerator with
    two downsamplings, slot for slot (`model.1`, `model.4`, ...)."""

    def __init__(self, input_nc: int, output_nc: int, ngf: int = 64,
                 n_blocks: int = 6):
        super().__init__(input_nc, output_nc, ngf, n_downsampling=2,
                         n_blocks=n_blocks)


class UnetSkipBlock(nn.Module):
    """UnetSkipConnectionBlock (ref networks.py:261-305): `model` holds
    [downconv, sub, uprelu, upconv, tanh] outermost, [downrelu, downconv,
    uprelu, upconv, upnorm] innermost, [downrelu, downconv, downnorm, sub,
    uprelu, upconv, upnorm] between; each but the outermost returns
    cat(x, model(x))."""

    def __init__(self, outer_nc: int, inner_nc: int, input_nc: int,
                 sub=None, outermost: bool = False, innermost: bool = False):
        super().__init__()
        self.outermost = outermost
        down = nn.Conv2d(input_nc, inner_nc, 4, stride=2, padding=1)
        up = nn.ConvTranspose2d(inner_nc if innermost else inner_nc * 2,
                                outer_nc, 4, stride=2, padding=1)
        if outermost:
            layers = [down, sub, nn.ReLU(), up, nn.Tanh()]
        elif innermost:
            layers = [nn.LeakyReLU(0.2), down, nn.ReLU(), up, InstanceNorm()]
        else:
            layers = [nn.LeakyReLU(0.2), down, InstanceNorm(), sub, nn.ReLU(),
                      up, InstanceNorm()]
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        y = self.model(x)
        return y if self.outermost else torch.cat([x, y], dim=1)


class UnetGenerator(nn.Module):
    """ref networks.py:249-258: num_downs halvings, the innermost block
    first; the skip is the channel concat of x and the block's output."""

    def __init__(self, input_nc: int, output_nc: int, num_downs: int,
                 ngf: int = 64):
        super().__init__()
        b = UnetSkipBlock(ngf * 8, ngf * 8, ngf * 8, innermost=True)
        for _ in range(num_downs - 5):
            b = UnetSkipBlock(ngf * 8, ngf * 8, ngf * 8, b)
        b = UnetSkipBlock(ngf * 4, ngf * 8, ngf * 4, b)
        b = UnetSkipBlock(ngf * 2, ngf * 4, ngf * 2, b)
        b = UnetSkipBlock(ngf, ngf * 2, ngf, b)
        self.model = UnetSkipBlock(output_nc, ngf, input_nc, b, outermost=True)

    def forward(self, x):
        return self.model(x)


class AffineInstanceNorm(nn.Module):
    """InstanceNorm2d(affine=True): `instance_norm` (a 1x1 map normalises
    to 0, as in the JAX package; torch's own refuses it) times weight plus
    bias."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return (instance_norm(x) * self.weight[:, None, None]
                + self.bias[:, None, None])


class Classifier(nn.Module):
    """ref networks.py:567-601: k3 s2 unpadded convs with LeakyReLU 0.2
    (`before_linear`), the map flattened in CHW order, two Linears with
    no activation between them (`after_linear`), as written there."""

    def __init__(self, input_nc: int, ndf: int):
        super().__init__()
        seq = [nn.Conv2d(input_nc, ndf, 3, stride=2), nn.LeakyReLU(0.2)]
        nf_mult = 1
        for n in range(3):
            prev, nf_mult = nf_mult, min(2 ** n, 8)
            seq += [nn.Conv2d(ndf * prev, ndf * nf_mult, 3, stride=2),
                    AffineInstanceNorm(ndf * nf_mult), nn.LeakyReLU(0.2)]
        self.before_linear = nn.Sequential(*seq)
        self.after_linear = nn.Sequential(nn.Linear(ndf * nf_mult, 1024),
                                          nn.Linear(1024, 10))

    def forward(self, x):
        h = self.before_linear(x)
        return self.after_linear(h.reshape(h.shape[0], -1))
