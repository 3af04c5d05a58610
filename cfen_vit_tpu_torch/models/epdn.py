"""The EPDN (enhanced pix2pixHD) network family, NCHW (counterpart of
cfen_vit_tpu/models/epdn.py; the reference's epdn/epdn_networks.py).

  * GlobalGenerator  <- epdn_networks.py:359-387: c7s1, n stride-2 downs,
    ResnetBlocks, transposed ups, c7s1 + tanh; InstanceNorm and ReLU; the
    reference's `model` Sequential slots (convs at 1, 4 + 3i, ...);
  * Dehaze           <- :313-357: the EPDN enhancer, 6 -> 20 channels, four
    VALID average pools (32, 16, 8, 4) each to a 1x1 conv and a nearest
    upsample back, concat, 3x3 conv + tanh; refine1 ... conv1040, refine3;
  * LocalEnhancer    <- :152-211: the global trunk without its c7s1 tail
    on the input pooled by AvgPool2d(3, 2, 1, count_include_pad=False),
    the local branch, then two chained Dehaze refiners; returns
    (enhanced, dehazed); pix2pixHD's names (model, model1_1, model1_2);
  * Encoder          <- :533-567 with its instance-wise mean (the mean of
    an instance id is taken over the whole batch, as the reference's is);
  * HeightWiseSFF, OmniFeatureExtractor, OmniLocalEnhancer <- the Omni
    family the reference keeps inside a string literal (:388-486; its
    ConELUBlock is Conv2d + ELU, as the JAX package reconstructs it); the
    SFF and extractor carry the literal's names, the enhancer (unrunnable
    in the reference, so without names of its own) the JAX tree's;
  * MultiscaleDiscriminator <- :569-608 over the epdn NLayerDiscriminator
    (:611-660: k4 convs padded by 2, channels capped at 512, stride 2 but
    for the last two); scale i runs `layer{num_D - 1 - i}` on the input
    pooled i times; returns each scale's features.

Every norm is the port's InstanceNorm (float32 statistics, affine off),
the reference define_G's default.  `_nearest_up_to` is torch's
"nearest-exact" (half-pixel centres), which is what jax.image.resize's
nearest gives; torch's "nearest" picks other pixels wherever the size
ratio is not an integer, as after a VALID pool that truncates.
`init_epdn` draws the JAX package's init distributions from a
torch.Generator.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.nn import InstanceNorm

# -- building blocks ---------------------------------------------------------


def _c7(cin: int, cout: int) -> List[nn.Module]:
    return [nn.ReflectionPad2d(3), nn.Conv2d(cin, cout, 7)]


def _down(cin: int, cout: int) -> List[nn.Module]:
    return [nn.Conv2d(cin, cout, 3, stride=2, padding=1), InstanceNorm(),
            nn.ReLU()]


def _convt(cin: int, cout: int) -> nn.ConvTranspose2d:
    return nn.ConvTranspose2d(cin, cout, 3, stride=2, padding=1,
                              output_padding=1)


def _up(cin: int, cout: int) -> List[nn.Module]:
    return [_convt(cin, cout), InstanceNorm(), nn.ReLU()]


class ResnetBlock(nn.Module):
    """pix2pixHD's reflect-padded block: x + [pad, conv3x3, IN, ReLU, pad,
    conv3x3, IN](x); convs at conv_block 1 and 5."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv_block = nn.Sequential(
            nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3), InstanceNorm(),
            nn.ReLU(), nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3),
            InstanceNorm())

    def forward(self, x):
        return x + self.conv_block(x)


def avg_pool_3s2(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(3, stride=2, padding=1, count_include_pad=False)."""
    return F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=False)


def _nearest_up_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return F.interpolate(x, size=(h, w), mode="nearest-exact")


# -- GlobalGenerator ---------------------------------------------------------


class GlobalGenerator(nn.Module):
    def __init__(self, input_nc=3, output_nc=3, ngf=64, n_downsampling=4,
                 n_blocks=9):
        super().__init__()
        seq = _c7(input_nc, ngf) + [InstanceNorm(), nn.ReLU()]
        for i in range(n_downsampling):
            seq += _down(ngf * 2 ** i, ngf * 2 ** (i + 1))
        seq += [ResnetBlock(ngf * 2 ** n_downsampling)
                for _ in range(n_blocks)]
        for i in range(n_downsampling):
            mult = 2 ** (n_downsampling - i)
            seq += _up(ngf * mult, ngf * mult // 2)
        seq += _c7(ngf, output_nc) + [nn.Tanh()]
        self.model = nn.Sequential(*seq)

    def forward(self, x):
        return self.model(x)


# -- Dehaze refiner (the EPDN enhancer) --------------------------------------

_DEHAZE_POOLS = ((32, "conv1010"), (16, "conv1020"), (8, "conv1030"),
                 (4, "conv1040"))


class Dehaze(nn.Module):
    def __init__(self, input_nc: int = 6):
        super().__init__()
        self.refine1 = nn.Conv2d(input_nc, 20, 3, padding=1)
        self.refine2 = nn.Conv2d(20, 20, 3, padding=1)
        for _, name in _DEHAZE_POOLS:
            setattr(self, name, nn.Conv2d(20, 1, 1))
        self.refine3 = nn.Conv2d(20 + 4, 3, 3, padding=1)

    def forward(self, x):
        d = F.leaky_relu(self.refine1(x), 0.2)
        d = F.leaky_relu(self.refine2(d), 0.2)
        h, w = d.shape[2:]
        outs = [_nearest_up_to(F.leaky_relu(getattr(self, name)(
            F.avg_pool2d(d, k)), 0.2), h, w) for k, name in _DEHAZE_POOLS]
        return torch.tanh(self.refine3(torch.cat(outs + [d], dim=1)))


# -- LocalEnhancer ------------------------------------------------------------


class LocalEnhancer(nn.Module):
    """pix2pixHD's one-enhancer LocalEnhancer with EPDN's two refiners:
    `model` the global trunk (ngf * 2) minus its c7s1 tail, `model1_1` the
    local downsample, `model1_2` the local blocks, up and c7s1 tail."""

    def __init__(self, input_nc=3, output_nc=3, ngf=32,
                 n_downsample_global=4, n_blocks_global=9, n_blocks_local=3):
        super().__init__()
        trunk = GlobalGenerator(input_nc, output_nc, ngf * 2,
                                n_downsample_global, n_blocks_global).model
        self.model = nn.Sequential(*list(trunk)[:-3])
        self.model1_1 = nn.Sequential(*_c7(input_nc, ngf), InstanceNorm(),
                                      nn.ReLU(), *_down(ngf, ngf * 2))
        self.model1_2 = nn.Sequential(
            *[ResnetBlock(ngf * 2) for _ in range(n_blocks_local)],
            *_up(ngf * 2, ngf), *_c7(ngf, output_nc), nn.Tanh())
        self.dehaze = Dehaze(6)
        self.dehaze2 = Dehaze(6)

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        coarse = self.model(avg_pool_3s2(x))
        out = self.model1_2(self.model1_1(x) + coarse)
        dh = self.dehaze(torch.cat([out, x], dim=1))
        dh = self.dehaze2(torch.cat([out, dh], dim=1))
        return out, dh


# -- Encoder (pix2pixHD feature encoder) --------------------------------------


class Encoder(nn.Module):
    def __init__(self, input_nc=3, output_nc=3, ngf=32, n_downsampling=4):
        super().__init__()
        seq = _c7(input_nc, ngf) + [InstanceNorm(), nn.ReLU()]
        for i in range(n_downsampling):
            seq += _down(ngf * 2 ** i, ngf * 2 ** (i + 1))
        for i in range(n_downsampling):
            mult = 2 ** (n_downsampling - i)
            seq += _up(ngf * mult, ngf * mult // 2)
        seq += _c7(ngf, output_nc) + [nn.Tanh()]
        self.model = nn.Sequential(*seq)

    def forward(self, x, inst, num_labels: int = 32):
        """inst: [B, 1, H, W] integer instance ids; each pixel of id l gets
        the mean of the output over every pixel of id l in the batch (ids
        outside [0, num_labels) give 0, as the JAX one-hot does)."""
        y = self.model(x)
        onehot = (inst[:, 0, :, :, None] == torch.arange(
            num_labels, device=inst.device)).to(y.dtype)       # [B,H,W,L]
        sums = torch.einsum("bhwl,bchw->lc", onehot, y)
        cnts = onehot.sum(dim=(0, 1, 2))[:, None].clamp_min(1.0)
        return torch.einsum("bhwl,lc->bchw", onehot, sums / cnts)


# -- the Omni family -----------------------------------------------------------


class ConELU(nn.Module):
    """The reference's ConELUBlock as reconstructed: Conv2d + ELU."""

    def __init__(self, cin, cout, kernel, padding):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, padding=padding)

    def forward(self, x):
        return F.elu(self.conv(x))


class HeightWiseSFF(nn.Module):
    """HeightWise_SFF_Model (:428-484): selective fusion of four maps with
    the image height in the channel's role; the per-(b, h) statistic is
    the mean over channels and width."""

    def __init__(self, channels: int, height: int, reduction: int = 4):
        super().__init__()
        d = max(height // reduction, 4)
        self.conv_squeeze = nn.Sequential(nn.Conv2d(height, d, 1, bias=False),
                                          nn.PReLU())
        for i in range(4):
            setattr(self, f"fcs_f{i}", nn.Conv2d(d, height, 1, bias=False))
        self.conv_smooth = ConELU(channels, channels, (5, 3), (2, 1))

    def forward(self, x0, x1, x2, x3):
        fuse = x0 + x1 + x2 + x3                                # [B,C,H,W]
        sq = self.conv_squeeze(fuse.mean(dim=(1, 3))[:, :, None, None])
        scores = torch.stack([getattr(self, f"fcs_f{i}")(sq)[:, :, 0, 0]
                              for i in range(4)], dim=-1)       # [B,H,4]
        att = torch.softmax(scores, dim=-1)[:, None, :, None, :]
        sel = sum(att[..., i] * x for i, x in enumerate((x0, x1, x2, x3)))
        return self.conv_smooth(sel + fuse)


# (kernel, padding) of the two ConELU banks (:397-405)
_OFE_BANK0 = (((3, 9), (1, 4)), ((5, 11), (2, 5)), ((5, 7), (2, 3)),
              ((7, 7), (3, 3)))
_OFE_BANK1 = (((3, 9), (1, 4)), ((3, 7), (1, 3)), ((3, 5), (1, 2)),
              ((5, 5), (2, 2)))


class OmniFeatureExtractor(nn.Module):
    """Two four-way multi-aspect ConELU banks, each fused by a HeightWise
    SFF sized to the input height (:389-426)."""

    def __init__(self, input_nc=3, ngf=32, n_height=128):
        super().__init__()
        for i, (k, p) in enumerate(_OFE_BANK0):
            setattr(self, f"extractor_0_{i}", ConELU(input_nc, ngf // 2, k, p))
        for i, (k, p) in enumerate(_OFE_BANK1):
            setattr(self, f"extractor_1_{i}", ConELU(ngf // 2, ngf, k, p))
        self.rwsff_0 = HeightWiseSFF(ngf // 2, n_height)
        self.rwsff_1 = HeightWiseSFF(ngf, n_height)

    def forward(self, x):
        f = self.rwsff_0(*[getattr(self, f"extractor_0_{i}")(x)
                           for i in range(4)])
        return self.rwsff_1(*[getattr(self, f"extractor_1_{i}")(f)
                              for i in range(4)])


class _OmniLevel(nn.Module):
    def __init__(self, conv: nn.Module, dim: int):
        super().__init__()
        self.conv = conv
        self.block = ResnetBlock(dim)


class _OmniTrunk(nn.Module):
    """n stride-2 downs, each with a ResnetBlock after it, the blocks,
    then `n_up` transposed ups with a ResnetBlock after each."""

    def __init__(self, ngf, nd, n_blocks, n_up):
        super().__init__()
        self.down = nn.ModuleList(
            _OmniLevel(nn.Conv2d(ngf * 2 ** i, ngf * 2 ** (i + 1), 3, 2, 1),
                       ngf * 2 ** (i + 1)) for i in range(nd))
        self.blocks = nn.Sequential(*[ResnetBlock(ngf * 2 ** nd)
                                      for _ in range(n_blocks)])
        self.up = nn.ModuleList(
            _OmniLevel(_convt(ngf * 2 ** (nd - i), ngf * 2 ** (nd - i) // 2),
                       ngf * 2 ** (nd - i) // 2) for i in range(n_up))

    def forward(self, x):
        for lvl in self.down:
            x = lvl.block(F.relu(InstanceNorm()(lvl.conv(x))))
        x = self.blocks(x)
        for lvl in self.up:
            x = lvl.block(F.relu(InstanceNorm()(lvl.conv(x))))
        return x


class OmniLocalEnhancer(nn.Module):
    """OmniLocalEnhancer (:216-311): coarse and fine Omni-extractor trunks
    (the fine one stops one upsample short), fused by a transposed conv,
    local blocks and a c5 / c7 tail (no norm or activation between them,
    the reference's quirk), then the two chained Dehaze refiners.  The
    input height must be the `n_height` the SFFs were sized for."""

    def __init__(self, input_nc=3, output_nc=3, ngf=32,
                 n_downsample_global=4, n_blocks_global=9, n_blocks_local=3,
                 n_height=128):
        super().__init__()
        nd = n_downsample_global
        self.ext_coarse = OmniFeatureExtractor(input_nc, ngf, n_height // 2)
        self.ext_fine = OmniFeatureExtractor(input_nc, ngf, n_height)
        self.coarse = _OmniTrunk(ngf, nd, n_blocks_global, nd)
        self.fine = _OmniTrunk(ngf, nd, n_blocks_global, nd - 1)
        # in: fine (2 ngf) ++ coarse (ngf); the reference's norm_layer(ngf)
        # on 2 ngf channels normalises all of them (affine off)
        self.final_up = _convt(3 * ngf, 2 * ngf)
        self.final_blocks = nn.Sequential(*[ResnetBlock(2 * ngf)
                                            for _ in range(n_blocks_local)])
        self.final_c5 = nn.Conv2d(2 * ngf, ngf, 5)
        self.final_c7 = nn.Conv2d(ngf, output_nc, 7)
        self.dehaze = Dehaze(6)
        self.dehaze2 = Dehaze(6)

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        coarse = self.coarse(self.ext_coarse(avg_pool_3s2(x)))
        fine = self.fine(self.ext_fine(x))
        y = F.relu(InstanceNorm()(self.final_up(torch.cat([fine, coarse], 1))))
        y = self.final_blocks(y)
        y = self.final_c5(F.pad(y, (2,) * 4, mode="reflect"))
        out = torch.tanh(self.final_c7(F.pad(y, (3,) * 4, mode="reflect")))
        dh = self.dehaze(torch.cat([out, x], dim=1))
        dh = self.dehaze2(torch.cat([out, dh], dim=1))
        return out, dh


# -- MultiscaleDiscriminator ---------------------------------------------------


def nlayer_discriminator(input_nc, ndf=64, n_layers=3,
                         use_sigmoid=False) -> nn.Sequential:
    """The epdn NLayerDiscriminator's `model` Sequential (getIntermFeat
    off): k4 convs padded by 2, stride 2 for the first n_layers."""
    seq = [nn.Conv2d(input_nc, ndf, 4, 2, 2), nn.LeakyReLU(0.2)]
    nf = ndf
    for n in range(1, n_layers + 1):
        prev, nf = nf, min(nf * 2, 512)
        seq += [nn.Conv2d(prev, nf, 4, 2 if n < n_layers else 1, 2),
                InstanceNorm(), nn.LeakyReLU(0.2)]
    seq += [nn.Conv2d(nf, 1, 4, 1, 2)]
    if use_sigmoid:
        seq += [nn.Sigmoid()]
    return nn.Sequential(*seq)


def nlayer_features(model: nn.Sequential, x) -> List[torch.Tensor]:
    """Each block's output (the input of each conv after the first, and the
    last output): pix2pixHD's getIntermFeat features, with the sigmoid on
    the last."""
    feats = []
    for i, m in enumerate(model):
        if isinstance(m, nn.Conv2d) and i:
            feats.append(x)
        x = m(x)
    return feats + [x]


class MultiscaleDiscriminator(nn.Module):
    def __init__(self, input_nc, ndf=64, n_layers=3, num_D=3,
                 use_sigmoid=False):
        super().__init__()
        self.num_D = num_D
        for i in range(num_D):
            setattr(self, f"layer{i}",
                    nlayer_discriminator(input_nc, ndf, n_layers, use_sigmoid))

    def forward(self, x, get_interm_feat: bool = False) -> List:
        """Per scale (finest first) its features, or a list of its last
        one; scale i uses layer{num_D - 1 - i}."""
        results = []
        for i in range(self.num_D):
            feats = nlayer_features(getattr(self, f"layer{self.num_D - 1 - i}"),
                                    x)
            results.append(feats if get_interm_feat else [feats[-1]])
            if i != self.num_D - 1:
                x = avg_pool_3s2(x)
        return results


@torch.no_grad()
def init_epdn(net: nn.Module, gen: torch.Generator) -> nn.Module:
    """The JAX epdn init distributions from `gen`: kaiming-normal (fan_in)
    weights (a ConvTranspose2d's fan_in is out-channels * k * k, as torch
    counts it; a 1x1 conv standing for a linear, its input channels),
    zero biases; PReLU keeps 0.25."""
    for m in net.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            m.weight.normal_(0.0, math.sqrt(2.0 / m.weight[0].numel()),
                             generator=gen)
            if m.bias is not None:
                m.bias.zero_()
    return net
