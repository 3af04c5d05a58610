"""Plain reference of EPDN ("Enhanced Pix2pix Dehazing Network", Qu, Chen,
Dong and Lu, CVPR 2019) and of its pix2pixHD GAN step, float32 NCHW,
plain torch operations with its own instance norm: the yardstick that
decides `correct` in the cell epdn_train_b4_fp32.  It follows the
reference repository's vendored epdn/:

  * GlobalGenerator (epdn_networks.py:359-387): reflect-padded c7s1,
    stride-2 downsamplings, reflect-padded ResnetBlocks, transposed
    upsamplings, each conv but the last followed by an instance norm
    (affine off) and a ReLU;
  * LocalEnhancer (:152-211), one local enhancer: the global trunk at
    twice the local width, without its c7s1 tail, on the input pooled by
    AvgPool2d(3, 2, 1, count_include_pad=False); the local c7s1 and
    downsampling, added to the trunk's output; the local ResnetBlocks,
    upsampling and c7s1 + tanh; then EPDN's two chained Dehaze blocks
    over cat(output, input) and cat(output, first block's answer);
  * Dehaze (:313-357): two 3x3 convs to 20 channels with LeakyReLU 0.2,
    four average pools (32, 16, 8, 4) each through a 1x1 conv to one
    channel, LeakyReLU and a nearest upsample back, concatenated with the
    20 channels, a 3x3 conv to 3 and tanh;
  * MultiscaleDiscriminator (:569-608) over NLayerDiscriminator
    (:611-660) with getIntermFeat: k4 convs padded by 2, LeakyReLU 0.2,
    widths doubling to at most 512, stride 2 but for the last two, an
    instance norm after each conv but the first and the last; each
    block's output is a feature; scale i runs the D of index num_D - 1 - i
    on the input pooled i times;
  * the step (pix2pixHD_model.py:28-190): G loss GAN(D(fake), real) over
    the scales' last outputs (LSGAN: mean squared error against 1 or 0,
    summed over the scales) + feature matching (4 / (n_layers_D + 1) /
    num_D * lambda_feat times the L1 of each scale's features but the
    last against the real pair's, detached) + VGG (pix2pixHD's VGGLoss,
    weights 1/32 ... 1 on relu1_1 ... relu5_1, of the enhanced output
    against the clear image, times lambda_feat) + L2 (mean squared error
    of the enhanced output); D loss 0.5 (GAN(D(pooled fake pair), fake) +
    GAN(D(real pair), real)); grads of each loss for its own network at
    the weights from before the step; Adam (beta1, 0.999, eps 1e-8).

Departures, each deliberate:
  * the image pool (pix2pixHD's util/image_pool.py) draws from a
    torch.Generator instead of Python's `random`, and draws both numbers
    (the coin, then the slot) for every image, as the port's `pool_query`
    does, so that from the same generator state both pick the same
    slots: the pool's answer is part of the step;
  * weights are the benchmark's seeded draws (reference/weights.py:
    kaiming-normal, zero biases), not pix2pixHD's N(0, 0.02), and the
    VGG19 is seeded (reference/losses.py), not ImageNet's: both sides
    get the same state dicts;
  * parameter names are the port's checkpoints' (the D's `layer{i}`
    Sequential of NLayerDiscriminator without getIntermFeat; the
    features are read off it block by block), so one state dict loads
    into both;
  * modules that no forward reaches are not built, and the learning rate
    is constant over the few steps a check takes;
  * the nearest upsample is torch's "nearest", as the Dehaze block's
    F.upsample; the port's "nearest-exact" picks the same pixels at
    every side that 32 divides.

D(real) runs once a step, as in pix2pixHD, for both losses.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import losses as L

DEHAZE_POOLS = ((32, "conv1010"), (16, "conv1020"), (8, "conv1030"),
                (4, "conv1040"))


def instance_norm(x, eps: float = 1e-5):
    """InstanceNorm2d(affine=False): two-pass biased variance."""
    mu = x.mean(dim=(2, 3), keepdim=True)
    d = x - mu
    return d * torch.rsqrt(d.square().mean(dim=(2, 3), keepdim=True) + eps)


class Norm(nn.Module):
    """The instance norm in a Sequential slot (no parameters)."""

    def forward(self, x):
        return instance_norm(x)


def pool_3s2(x):
    return F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=False)


class ResnetBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv_block = nn.Sequential(
            nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3), Norm(), nn.ReLU(),
            nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3), Norm())

    def forward(self, x):
        return x + self.conv_block(x)


def global_trunk(ngf: int, n_down: int, n_blocks: int) -> List[nn.Module]:
    """GlobalGenerator's `model` without its c7s1 tail (3 -> ngf)."""
    seq = [nn.ReflectionPad2d(3), nn.Conv2d(3, ngf, 7), Norm(), nn.ReLU()]
    for i in range(n_down):
        seq += [nn.Conv2d(ngf * 2 ** i, ngf * 2 ** (i + 1), 3, 2, 1), Norm(),
                nn.ReLU()]
    seq += [ResnetBlock(ngf * 2 ** n_down) for _ in range(n_blocks)]
    for i in range(n_down):
        c = ngf * 2 ** (n_down - i)
        seq += [nn.ConvTranspose2d(c, c // 2, 3, 2, 1, output_padding=1),
                Norm(), nn.ReLU()]
    return seq


class Dehaze(nn.Module):
    def __init__(self, channels: int = 20):
        super().__init__()
        self.refine1 = nn.Conv2d(6, channels, 3, padding=1)
        self.refine2 = nn.Conv2d(channels, channels, 3, padding=1)
        for _, name in DEHAZE_POOLS:
            setattr(self, name, nn.Conv2d(channels, 1, 1))
        self.refine3 = nn.Conv2d(channels + len(DEHAZE_POOLS), 3, 3, padding=1)

    def forward(self, x):
        d = F.leaky_relu(self.refine1(x), 0.2)
        d = F.leaky_relu(self.refine2(d), 0.2)
        size = d.shape[2:]
        ups = [F.interpolate(F.leaky_relu(getattr(self, name)(
            F.avg_pool2d(d, k)), 0.2), size=size, mode="nearest")
            for k, name in DEHAZE_POOLS]
        return torch.tanh(self.refine3(torch.cat(ups + [d], 1)))


class LocalEnhancer(nn.Module):
    """(pix2pixHD's output, the enhanced output) of a hazy image."""

    def __init__(self, config: dict):
        super().__init__()
        ngf = config["ngf"]
        self.model = nn.Sequential(*global_trunk(
            config["ngf_global"], config["n_downsample_global"],
            config["n_blocks_global"]))
        self.model1_1 = nn.Sequential(
            nn.ReflectionPad2d(3), nn.Conv2d(3, ngf, 7), Norm(), nn.ReLU(),
            nn.Conv2d(ngf, 2 * ngf, 3, 2, 1), Norm(), nn.ReLU())
        self.model1_2 = nn.Sequential(
            *[ResnetBlock(2 * ngf) for _ in range(config["n_blocks_local"])],
            nn.ConvTranspose2d(2 * ngf, ngf, 3, 2, 1, output_padding=1),
            Norm(), nn.ReLU(), nn.ReflectionPad2d(3), nn.Conv2d(ngf, 3, 7),
            nn.Tanh())
        if config["dehaze_blocks"] != 2:
            raise ValueError("EPDN chains two Dehaze blocks")
        self.dehaze = Dehaze(config["dehaze_channels"])
        self.dehaze2 = Dehaze(config["dehaze_channels"])

    def forward(self, x):
        out = self.model1_2(self.model1_1(x) + self.model(pool_3s2(x)))
        dh = self.dehaze(torch.cat([out, x], 1))
        return out, self.dehaze2(torch.cat([out, dh], 1))


def nlayer(ndf: int, n_layers: int) -> nn.Sequential:
    seq = [nn.Conv2d(6, ndf, 4, 2, 2), nn.LeakyReLU(0.2)]
    nf = ndf
    for n in range(1, n_layers + 1):
        prev, nf = nf, min(nf * 2, 512)
        seq += [nn.Conv2d(prev, nf, 4, 2 if n < n_layers else 1, 2), Norm(),
                nn.LeakyReLU(0.2)]
    return nn.Sequential(*seq, nn.Conv2d(nf, 1, 4, 1, 2))


class MultiscaleDiscriminator(nn.Module):
    def __init__(self, config: dict):
        super().__init__()
        self.num_d = config["num_D"]
        for i in range(self.num_d):
            setattr(self, f"layer{i}", nlayer(config["ndf"],
                                              config["n_layers_D"]))

    def forward(self, x) -> List[List[torch.Tensor]]:
        """Per scale, finest first, each block's output (the last is the
        patch prediction)."""
        out = []
        for i in range(self.num_d):
            feats = []
            h = x
            for j, m in enumerate(getattr(self, f"layer{self.num_d - 1 - i}")):
                if isinstance(m, nn.Conv2d) and j:
                    feats.append(h)
                h = m(h)
            out.append(feats + [h])
            if i != self.num_d - 1:
                x = pool_3s2(x)
        return out


def gan(preds, real: bool):
    return sum(L.lsgan(p[-1], real) for p in preds)


class Pool:
    """pix2pixHD's ImagePool over [C, H, W] images, with the draws above."""

    def __init__(self, size: int, gen: torch.Generator):
        self.size, self.gen = size, gen
        self.images: List[torch.Tensor] = []

    def query(self, images):
        if self.size <= 0:
            return images
        out = []
        for img in images:
            coin = torch.rand((), generator=self.gen).item()
            slot = int(torch.randint(0, self.size, (), generator=self.gen))
            if len(self.images) < self.size:
                self.images.append(img.clone())
                out.append(img)
            elif coin > 0.5:
                out.append(self.images[slot])
                self.images[slot] = img.clone()
            else:
                out.append(img)
        return torch.stack(out)


class RefEpdn:
    """The step over given networks, pool and VGG19."""

    def __init__(self, config: dict, g, d, vgg, pool: Pool, lr: float,
                 beta1: float):
        self.config, self.g, self.d, self.pool = config, g, d, pool
        self.vgg = vgg.requires_grad_(False)
        adam = dict(lr=lr, betas=(beta1, 0.999), eps=1e-8)
        self.g_opt = torch.optim.Adam(self.g.parameters(), **adam)
        self.d_opt = torch.optim.Adam(self.d.parameters(), **adam)

    def losses(self, hazy, real):
        """(G terms, D terms, fake) at the current weights."""
        c = self.config
        fake, enhance = self.g(hazy)
        self.fakes = {"fake_A": enhance.detach(),
                      "fake_A_synth": fake.detach()}
        pred_fake = self.d(torch.cat([hazy, fake], 1))
        pred_real = self.d(torch.cat([hazy, real], 1))
        w = 4.0 / (c["n_layers_D"] + 1) / c["num_D"] * c["lambda_feat"]
        g = {"G_GAN": gan(pred_fake, True),
             "G_GAN_Feat": sum(w * torch.mean(torch.abs(f - r.detach()))
                               for pf, pr in zip(pred_fake, pred_real)
                               for f, r in zip(pf[:-1], pr[:-1])),
             "G_VGG": L.perceptual(self.vgg, enhance, real) * c["lambda_feat"],
             "G_L2": torch.mean(torch.square(enhance - real))}
        pooled = self.pool.query(torch.cat([hazy, fake.detach()], 1))
        d = {"D_fake": gan(self.d(pooled), False),
             "D_real": gan(pred_real, True)}
        return g, d

    def step(self, batch: dict) -> dict:
        """One step on NCHW float32 B (hazy) and A (clear) in [-1, 1];
        the losses as floats."""
        g, d = self.losses(batch["B"], batch["A"])
        g_total = sum(g.values())
        d_total = 0.5 * (d["D_fake"] + d["D_real"])
        for net, total in ((self.g, g_total), (self.d, d_total)):
            params = list(net.parameters())
            for p, gr in zip(params, torch.autograd.grad(total, params)):
                p.grad = gr
        out = {k: float(v.detach()) for k, v in {**g, **d}.items()}
        out["G"] = float(g_total.detach())
        for opt in self.optimizers():
            opt.step()
            opt.zero_grad(set_to_none=True)
        return out

    def visuals(self) -> dict:
        """The last step's outputs as host NHWC float32, named as the
        port's get_current_visuals names them."""
        return {k: v.permute(0, 2, 3, 1).cpu().numpy()
                for k, v in self.fakes.items()}

    def leaves(self) -> dict:
        """name -> parameter: G.<name>, D.<name>."""
        out = {f"G.{k}": p for k, p in self.g.named_parameters()}
        out.update({f"D.{k}": p for k, p in self.d.named_parameters()})
        return out

    def optimizers(self):
        return (self.g_opt, self.d_opt)


def shapes(module: nn.Module) -> Dict[str, tuple]:
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}
