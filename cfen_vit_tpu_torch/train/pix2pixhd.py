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
(beta1 --beta1, beta2 0.999, eps 1e-8) at lr_for_epoch, which the train
CLI steps each epoch as it does for the dehazing trainer; no skip gate.
The step is eager: no CUDA graph.  Batches take the dehazing trainer's
wire (`host_wire`, `copy_in`, `normalise`).

The widths come from the flags: --epdn_ngf the local branch (the global
trunk twice it, pix2pixHD's 4 downsamplings, 9 blocks and 3 local
blocks), --ndf, --n_layers_D and --num_D the discriminator,
--lambda_feat, --no_lsgan.  --n_downsample_global and --n_blocks are
parity flags this trainer does not read.

The wrapper surface is the dehazing trainer's, so `python -m
cfen_vit_tpu_torch.train --model epdn` runs it through `create_model`
(the JAX package's create_model has no `epdn`): set_input /
optimize_parameters / get_current_losses / get_current_visuals /
networks / setup / save_networks (`<epoch>_net_G.pth`, `_net_D.pth`,
`<tag>_train_state.pt`) / update_learning_rate.  One process: a
launched mesh and --grad_accum above 1 are refused.

Spans (utils/profiling.py, which lists them): `train.set_input`; and
`train.step` around `train.g_loss` (`train.g_forward` with
`train.dehaze`, the two enhancer blocks, inside it; `train.d_on_fake`;
`train.feat_match`, D on the real pair and the L1 terms; `train.vgg`),
`train.g_backward`, `train.pool`, `train.d_step`, `train.adam` and
`train.zero_grad`; `sync.losses`, `sync.visuals` around the reads.  The
counter `d_passes` counts each MultiscaleDiscriminator forward, four a
step; `syncs` the reads, none inside the step.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..losses.gan import gan_loss
from ..losses.vgg import vgg19_init, vgg_perceptual_loss
from ..models.epdn import LocalEnhancer, MultiscaleDiscriminator, init_epdn
from ..parallel import mesh as M
from ..utils.profiling import annotate, count
from .checkpoint import load_train_state, save_net, save_train_state
from .schedule import lr_for_epoch
from .trainer import copy_in, host_wire, normalise, pool_init, pool_query


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
        if M.current().launched:
            raise NotImplementedError("--model epdn trains in one process: "
                                      "no --mesh_shape")
        if int(cfg.grad_accum) > 1:
            raise NotImplementedError("--model epdn takes no --grad_accum")
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
        self.epoch = cfg.epoch_count
        self.lr = lr_for_epoch(cfg, 0)
        adam = dict(lr=self.lr, betas=(cfg.beta1, 0.999), eps=1e-8)
        self.g_opt = torch.optim.Adam(self.g.parameters(), **adam)
        self.d_opt = torch.optim.Adam(self.d.parameters(), **adam)
        self.pool_gen = torch.Generator().manual_seed(int(cfg.seed) + 1)
        self.pool = None
        self.step = 0
        self.batches = 0         # taken by set_input: the unit id of spans
        self._batch: Dict[str, torch.Tensor] = {}
        self._losses: Dict[str, torch.Tensor] = {}
        self._fake = None
        self._enhance = None

    def networks(self) -> Dict[str, torch.nn.Module]:
        """The checkpointed networks by slot name (`<epoch>_net_<name>`)."""
        return {"G": self.g, "D": self.d}

    def load_state_dicts(self, g=None, d=None, vgg=None) -> None:
        for net, sd in ((self.g, g), (self.d, d), (self.vgg, vgg)):
            if sd is not None:
                net.load_state_dict(sd, strict=True)

    def setup(self, cfg=None) -> None:
        cfg = cfg or self.cfg
        if cfg.continue_train:
            st = load_train_state(cfg, cfg.which_epoch, self.device)
            self.load_state_dicts(st["g"], st["d"])
            self.g_opt.load_state_dict(st["g_opt"])
            self.d_opt.load_state_dict(st["d_opt"])
            self.pool_gen.set_state(st["pool_gen"])
            self.step = int(st["step"])

    def _discriminate(self, pair, get_interm_feat: bool = False) -> List:
        count("d_passes")
        return self.d(pair, get_interm_feat=get_interm_feat)

    def _g_loss(self, hazy, real):
        with annotate("train.g_forward"):
            fake = self.g.synthesize(hazy)
            with annotate("train.dehaze"):
                enhance = self.g.enhance(fake, hazy)
        self._fake, self._enhance = fake.detach(), enhance.detach()
        with annotate("train.d_on_fake"):
            pred_fake = self._discriminate(torch.cat([hazy, fake], dim=1),
                                           get_interm_feat=True)
            losses = {"G_GAN": epdn_gan_loss(pred_fake, True, self.use_lsgan)}
        with annotate("train.feat_match"):
            with torch.no_grad():
                pred_real = self._discriminate(torch.cat([hazy, real], dim=1),
                                               get_interm_feat=True)
            losses["G_GAN_Feat"] = feature_matching_loss(
                pred_fake, pred_real, self.n_layers_d, self.num_d,
                self.lambda_feat)
        with annotate("train.vgg"):
            losses["G_VGG"] = (vgg_perceptual_loss(self.vgg, enhance, real)
                               * self.lambda_feat)
        losses["G_L2"] = torch.mean(torch.square(enhance - real))
        return losses, fake

    def _d_loss(self, hazy, real, pooled_fake_cat):
        l_fake = epdn_gan_loss(self._discriminate(pooled_fake_cat), False,
                               self.use_lsgan)
        l_real = epdn_gan_loss(self._discriminate(
            torch.cat([hazy, real], dim=1)), True, self.use_lsgan)
        return 0.5 * (l_fake + l_real), {"D_fake": l_fake, "D_real": l_real}

    def set_input(self, batch: Dict) -> None:
        """The hazy (B) and clear (A) images on the device; the loader's
        other arrays (R, S of --dataset_mode dec_vit) stay on the host."""
        self.batches += 1
        with annotate("train.set_input", self.batches):
            wire = host_wire({k: batch[k] for k in ("A", "B")})
            self._batch = {k: normalise(v)
                           for k, v in copy_in(wire, self.device).items()}

    def optimize_parameters(self, cfg=None) -> None:
        with annotate("train.step", self.batches):
            self._optimize()

    def _optimize(self) -> None:
        hazy, real = self._batch["B"], self._batch["A"]
        if self.pool is None:
            self.pool = pool_init(self.cfg.pool_size, (6,) + hazy.shape[2:],
                                  self.pool_dtype, self.device)
        # the step reads nothing back from the device: the counter stays
        # in the record at 0
        count("syncs", 0)
        with annotate("train.g_loss"):
            losses, fake = self._g_loss(hazy, real)
            gl = sum(losses.values())
        with annotate("train.g_backward"):
            gl.backward(inputs=list(self.g.parameters()))
        # pix2pixHD trains D on the pooled fake pair (ref :135-143)
        with annotate("train.pool"):
            _, pooled = pool_query(self.pool,
                                   torch.cat([hazy, fake.detach()], 1),
                                   self.pool_gen)
        with annotate("train.d_step"):
            dl, d_losses = self._d_loss(hazy, real, pooled.to(hazy.dtype))
            dl.backward(inputs=list(self.d.parameters()))
        with annotate("train.adam"):
            for opt in (self.g_opt, self.d_opt):
                for group in opt.param_groups:
                    group["lr"] = self.lr
                opt.step()
        with annotate("train.zero_grad"):
            for opt in (self.g_opt, self.d_opt):
                opt.zero_grad(set_to_none=True)
        self.step += 1
        losses.update(d_losses)
        losses["G"] = gl
        self._losses = {k: v.detach() for k, v in losses.items()}

    def get_current_losses(self) -> Dict[str, float]:
        with annotate("sync.losses", self.batches):
            count("syncs", len(self._losses))
            return {k: float(v) for k, v in self._losses.items()}

    def get_current_visuals(self) -> Dict[str, np.ndarray]:
        """NHWC numpy: the hazy input, its clear target, the enhanced
        output (the one the L2 term trains) as fake_A and pix2pixHD's
        output before the enhancer as fake_A_synth."""
        def nhwc(t):
            count("syncs")
            return t.float().permute(0, 2, 3, 1).cpu().numpy()
        with annotate("sync.visuals", self.batches):
            return {"real_B": nhwc(self._batch["B"]),
                    "real_A": nhwc(self._batch["A"]),
                    "fake_A": nhwc(self._enhance),
                    "fake_A_synth": nhwc(self._fake)}

    def save_networks(self, epoch) -> None:
        for name, net in self.networks().items():
            save_net(self.cfg, epoch, name, net)
        save_train_state(self.cfg, str(epoch), {
            "g": self.g.state_dict(), "d": self.d.state_dict(),
            "g_opt": self.g_opt.state_dict(), "d_opt": self.d_opt.state_dict(),
            "pool_gen": self.pool_gen.get_state(), "step": self.step})

    def update_learning_rate(self) -> None:
        self.epoch += 1
        old = self.lr
        self.lr = lr_for_epoch(self.cfg, self.epoch - self.cfg.epoch_count)
        print(f"learning rate = {self.lr:.7f} (was {old:.7f})")
