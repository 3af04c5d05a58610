"""EPDN / pix2pixHD trainer (counterpart of cfen_vit_tpu/train/pix2pixhd.py;
the reference's epdn/pix2pixHD_model.py:28-190, which cannot be built
there, so this is its evident intent, as in the JAX package):

  netG = LocalEnhancer(hazy) -> (fake, enhance)           [models/epdn.py]
  netD = MultiscaleDiscriminator on cat(hazy, image), 6 channels
  G loss = G_GAN: GAN(D(fake), real) summed over the scales
         + G_GAN_Feat: sum over scales i and layers j < last of
           4 / (n_layers_D + 1) * 1 / num_D * L1(D_i,j(fake), D_i,j(real)
           without grad) * lambda_feat (ref :172-180)
         + G_VGG: VGG(enhance, real) * lambda_feat (ref :183-185)
         + G_L2: MSE(enhance, real) (ref :186)
  D loss = 0.5 (GAN(D(pooled cat(hazy, fake)), fake)
                + GAN(D(cat(hazy, real)), real))          (ref :160-165)

VGG and L2 see `enhance`, the Dehaze-refined output; D sees `fake`.
Unlike the dehazing trainer, D trains on the pool's answer.  Every
network runs in float32, as in JAX, where --compute_dtype only sets the
pool's dtype: a bf16 pooled pair reaches D as float32 (JAX's type
promotion).  Both losses use the parameters from before the step; Adam
(beta1 --beta1, beta2 0.999, eps 1e-8) at the constant --lr, with no skip
gate.  The wrapper surface is the JAX trainer's: set_input /
optimize_parameters / get_current_losses; no CLI runs it, as none runs
the JAX one.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..losses.gan import gan_loss
from ..losses.vgg import vgg19_init, vgg_perceptual_loss
from ..models.epdn import LocalEnhancer, MultiscaleDiscriminator, init_epdn
from .trainer import device_batch, pool_init, pool_query


def epdn_gan_loss(preds: List, target_real: bool,
                  lsgan: bool = True) -> torch.Tensor:
    """The epdn GANLoss over multiscale predictions: the loss of each
    scale's last feature, summed over the scales (ref epdn_networks.py
    :107-131)."""
    return sum(gan_loss(feats[-1], target_real, lsgan) for feats in preds)


def feature_matching_loss(pred_fake: List, pred_real: List, n_layers_d: int,
                          num_d: int, lambda_feat: float) -> torch.Tensor:
    """ref pix2pixHD_model.py:172-180; the real features without grad."""
    w = 4.0 / (n_layers_d + 1) / num_d * lambda_feat
    return sum(w * torch.mean(torch.abs(f - r.detach()))
               for i in range(num_d)
               for f, r in zip(pred_fake[i][:-1], pred_real[i][:-1]))


class EpdnTrainer:
    def __init__(self, cfg, device: torch.device):
        self.cfg = cfg
        self.device = device
        self.pool_dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                           else torch.float32)
        self.num_d = int(cfg.num_D)
        self.n_layers_d = int(cfg.n_layers_D)
        self.lambda_feat = float(cfg.lambda_feat)
        self.use_lsgan = not cfg.no_lsgan
        gen = torch.Generator().manual_seed(int(cfg.seed))
        self.g = init_epdn(LocalEnhancer(3, 3, int(cfg.epdn_ngf)),
                           gen).to(device)
        self.d = init_epdn(MultiscaleDiscriminator(
            6, cfg.ndf, self.n_layers_d, self.num_d), gen).to(device)
        self.vgg = vgg19_init(cfg.vgg19_npz or None).to(device)
        adam = dict(lr=float(cfg.lr), betas=(cfg.beta1, 0.999), eps=1e-8)
        self.g_opt = torch.optim.Adam(self.g.parameters(), **adam)
        self.d_opt = torch.optim.Adam(self.d.parameters(), **adam)
        self.pool_gen = torch.Generator().manual_seed(int(cfg.seed) + 1)
        self.pool = None
        self.step = 0
        self._batch: Dict[str, torch.Tensor] = {}
        self._losses: Dict[str, torch.Tensor] = {}
        self._enhance = None

    def load_state_dicts(self, g=None, d=None, vgg=None) -> None:
        for net, sd in ((self.g, g), (self.d, d), (self.vgg, vgg)):
            if sd is not None:
                net.load_state_dict(sd, strict=True)

    def _g_loss(self, hazy, real):
        fake, enhance = self.g(hazy)
        self._enhance = enhance.detach()
        pred_fake = self.d(torch.cat([hazy, fake], dim=1), get_interm_feat=True)
        with torch.no_grad():
            pred_real = self.d(torch.cat([hazy, real], dim=1),
                               get_interm_feat=True)
        losses = {
            "G_GAN": epdn_gan_loss(pred_fake, True, self.use_lsgan),
            "G_GAN_Feat": feature_matching_loss(
                pred_fake, pred_real, self.n_layers_d, self.num_d,
                self.lambda_feat),
            "G_VGG": vgg_perceptual_loss(self.vgg, enhance, real)
            * self.lambda_feat,
            "G_L2": torch.mean(torch.square(enhance - real)),
        }
        return losses, fake

    def _d_loss(self, hazy, real, pooled_fake_cat):
        l_fake = epdn_gan_loss(self.d(pooled_fake_cat), False, self.use_lsgan)
        l_real = epdn_gan_loss(self.d(torch.cat([hazy, real], dim=1)), True,
                               self.use_lsgan)
        return 0.5 * (l_fake + l_real), {"D_fake": l_fake, "D_real": l_real}

    def set_input(self, batch: Dict) -> None:
        self._batch = device_batch(batch, self.device)

    def optimize_parameters(self, cfg=None) -> None:
        hazy, real = self._batch["B"], self._batch["A"]
        if self.pool is None:
            self.pool = pool_init(self.cfg.pool_size, (6,) + hazy.shape[2:],
                                  self.pool_dtype, self.device)
        losses, fake = self._g_loss(hazy, real)
        gl = sum(losses.values())
        gl.backward(inputs=list(self.g.parameters()))
        # pix2pixHD trains D on the pooled fake pair (ref :135-143)
        _, pooled = pool_query(self.pool, torch.cat([hazy, fake.detach()], 1),
                               self.pool_gen)
        dl, d_losses = self._d_loss(hazy, real, pooled.to(hazy.dtype))
        dl.backward(inputs=list(self.d.parameters()))
        for opt in (self.g_opt, self.d_opt):
            opt.step()
            opt.zero_grad(set_to_none=True)
        self.step += 1
        losses.update(d_losses)
        losses["G"] = gl
        self._losses = {k: v.detach() for k, v in losses.items()}

    def get_current_losses(self) -> Dict[str, float]:
        return {k: float(v) for k, v in self._losses.items()}

    def get_current_visuals(self) -> Dict:
        """NHWC numpy: the hazy input, its clear target and the enhanced
        output (the one the L2 term trains) as fake_A."""
        def nhwc(t):
            return t.float().permute(0, 2, 3, 1).cpu().numpy()
        return {"real_B": nhwc(self._batch["B"]),
                "real_A": nhwc(self._batch["A"]),
                "fake_A": nhwc(self._enhance)}
