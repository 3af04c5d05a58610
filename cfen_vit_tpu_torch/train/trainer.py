"""Conditional-GAN trainer (counterpart of cfen_vit_tpu/train/trainer.py;
the reference's DECHLGVIT, model_iid_dehazing.py), `--model dec_vit`.

One `optimize_parameters` per batch, in the JAX package's order:
  1. generator forward and the 7-term G loss, grads of G only;
  2. the ImagePool advances with the current fakes, and its query result
     is discarded (the reference's backward_D builds fake_*_cat from the
     current fakes, ref :173-187), so D trains on un-pooled fakes;
  3. the LS-GAN D loss 0.5 (real + fake) on the current fakes, grads of D
     only; both losses use the parameters from before the step;
  4. the skip gate: isfinite(G) and G < --skip_threshold, else neither
     network, no Adam moment or step count and no pool changes;
  5. Adam (beta1 --beta1, beta2 0.999, eps 1e-8) on G and on D_A/D_R/D_S
     jointly, at lr_for_epoch.

G loss per branch A (dehazed), R, S (S expanded 1 -> 3 channels): GAN
x0.0618, VGG x2 lambda_vgg, gradient MSE x2, L1 x2, (1 - SSIM) x3; on A
only ID-MRF x0.06 and semantic consistency x2, both called as (real, fake)
as the reference does (the losses are asymmetric).

--compute_dtype bfloat16: float32 master parameters and moments.  The G
loss runs a bf16 copy of the generator whose parameters are refreshed
from the masters every step (a checkpointed region recomputes with the
module's own parameters, so torch.func.functional_call cannot stand in
for them there), and its grads are cast back to float32, which is what
JAX's cast gives; the ActNorm `initialized` buffers are not cast.  The D
and VGG parameters enter the G loss cast to bf16 (functional_call,
without grad: the G loss differentiates G only).  The D loss runs in
float32 on the float32 D, as JAX's type promotion makes it there.  The
ActNorms are initialised from the first batch in float32 before the first
step.
Batches travel as uint8 when that is lossless and are normalised on the
device.  Pools are device ring buffers in the compute dtype, updated in
place, sampled by a torch.Generator.
"""

from __future__ import annotations

import copy
import math
from typing import Dict

import numpy as np
import torch
from torch.func import functional_call

from ..losses.gan import gan_loss
from ..losses.vgg import (idmrf_loss, semantic_consistency_loss, vgg19_init,
                          vgg_perceptual_loss)
from ..models.discriminator import apply_d, define_d
from ..models.generator import Generator, init_weights
from ..models.registry import generator_spec
from ..ops.gradient import color_gradient
from ..ops.ssim import ssim
from .checkpoint import load_train_state, save_net, save_train_state
from .schedule import lr_for_epoch

_VISUAL = {"A": "fake_A", "R": "fake_R", "S": "fake_S"}


def _u8_wire(v: np.ndarray) -> np.ndarray:
    """float [-1,1] -> uint8 iff exactly recoverable (loader floats are
    u8 / 127.5 - 1); other arrays pass unchanged."""
    if v.dtype != np.float32 or v.ndim != 4:
        return v
    u8 = np.rint((v + 1.0) * 127.5)
    if u8.min() < 0 or u8.max() > 255:
        return v
    u8 = u8.astype(np.uint8)
    if np.array_equal(u8.astype(np.float32) / 127.5 - 1.0, v):
        return u8
    return v


# --------------------------------------------------------------------------
# device-side ImagePool
# --------------------------------------------------------------------------

def pool_init(pool_size: int, shape, dtype=torch.float32, device=None) -> Dict:
    """Ring buffer of `pool_size` images [C, H, W] plus one scratch row
    (index pool_size) that takes the write of an image that is not kept."""
    rows = pool_size + 1 if pool_size > 0 else 0
    return {"buf": torch.zeros((rows,) + tuple(shape), dtype=dtype,
                               device=device), "n": 0}


@torch.no_grad()
def pool_query(pool: Dict, images: torch.Tensor, gen: torch.Generator):
    """The reference's util/image_pool.py:12-31, image by image: below
    capacity store and return the image; else with p = 0.5 swap it with a
    random slot and return the old one, or return it unchanged.  Updates
    `pool` in place and returns (pool, outputs)."""
    size = pool["buf"].shape[0] - 1
    if size <= 0:
        return pool, images
    buf = pool["buf"]
    outs = []
    for img in images.to(buf.dtype):
        p = torch.rand((), generator=gen).item()
        rid = int(torch.randint(0, size, (), generator=gen))
        if pool["n"] < size:
            buf[pool["n"]] = img
            pool["n"] += 1
            outs.append(img)
        elif p > 0.5:
            outs.append(buf[rid].clone())
            buf[rid] = img
        else:
            buf[size] = img
            outs.append(img)
    return pool, torch.stack(outs)


# --------------------------------------------------------------------------
# trainer
# --------------------------------------------------------------------------

class GanTrainer:
    """The reference wrapper's interface: set_input / optimize_parameters /
    get_current_losses / get_current_visuals / save_networks /
    update_learning_rate."""

    def __init__(self, cfg, device: torch.device):
        if cfg.model != "dec_vit":
            raise NotImplementedError(
                f"--model {cfg.model}: the port trains dec_vit only; the "
                "other trainers are ROADMAP Queue A item 9")
        if int(cfg.grad_accum) > 1:
            raise NotImplementedError(
                "--grad_accum > 1 is not ported (ROADMAP Queue A item 8)")
        self.cfg = cfg
        self.device = device
        self.dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                      else torch.float32)
        self.spec = generator_spec(cfg.model_G, cfg)
        self.branches = {b: n for b, n in (("d", "A"), ("r", "R"), ("s", "S"))
                         if b in self.spec.branches}
        self.use_lsgan = not cfg.no_lsgan
        self.remat = (cfg.remat_mode or "level") if cfg.remat else "none"
        gen = torch.Generator().manual_seed(int(cfg.seed))
        self.g = init_weights(Generator(self.spec), gen).to(device)
        self.d = torch.nn.ModuleDict(
            {name: define_d(cfg, gen) for name in self.branches.values()}
        ).to(device)
        # a fixed seed, not --seed, as the JAX package's PRNGKey(1234): the
        # tower is not in the checkpoints
        self.vgg = vgg19_init(cfg.vgg19_npz or None).to(device, self.dtype)
        adam = dict(betas=(cfg.beta1, 0.999), eps=1e-8)
        self.g_opt = torch.optim.Adam(self.g.parameters(), lr=0.0, **adam)
        self.d_opt = torch.optim.Adam(self.d.parameters(), lr=0.0, **adam)
        self._g_c = None         # the bf16 compute copy of G
        self.pool_gen = torch.Generator().manual_seed(int(cfg.seed) + 1)
        self.pools: Dict[str, Dict] = {}
        self.step = 0
        self.epoch = cfg.epoch_count
        self.lr = lr_for_epoch(cfg, 0)
        self._batch: Dict[str, torch.Tensor] = {}
        self._losses: Dict[str, torch.Tensor] = {}
        self._fakes: Dict[str, torch.Tensor] = {}
        self.image_paths = []

    def load_state_dicts(self, g=None, d=None, vgg=None) -> None:
        """Start from given weights: a generator state_dict, {A/R/S: D
        state_dict}, a VGG19 state_dict."""
        if g is not None:
            self.g.load_state_dict(g, strict=True)
        for name, sd in (d or {}).items():
            self.d[name].load_state_dict(sd, strict=True)
        if vgg is not None:
            self.vgg.load_state_dict(vgg, strict=True)

    def setup(self, cfg=None) -> None:
        cfg = cfg or self.cfg
        if cfg.continue_train:
            st = load_train_state(cfg, cfg.which_epoch, self.device)
            self.load_state_dicts(st["g"], st["d"])
            self.g_opt.load_state_dict(st["g_opt"])
            self.d_opt.load_state_dict(st["d_opt"])
            self.pool_gen.set_state(st["pool_gen"])
            self.step = int(st["step"])

    # -- losses -------------------------------------------------------------
    def _cast(self, module: torch.nn.Module) -> Dict[str, torch.Tensor]:
        """module's parameters in the compute dtype, without grad, and its
        buffers as they are, for functional_call."""
        state = {k: p.detach().to(self.dtype)
                 for k, p in module.named_parameters()}
        state.update(module.named_buffers())
        return state

    def _g_compute(self) -> Generator:
        """The generator the G loss runs: the master in float32; in bf16 a
        copy refreshed from the masters."""
        if self.dtype == torch.float32:
            return self.g
        if self._g_c is None:
            self._g_c = copy.deepcopy(self.g).to(self.dtype)
        with torch.no_grad():
            for pc, pm in zip(self._g_c.parameters(), self.g.parameters()):
                pc.copy_(pm)
        return self._g_c

    def _g_loss(self, g, batch):
        cfg = self.cfg
        batch = {k: v.to(self.dtype) for k, v in batch.items()}
        out = g(batch["B"], remat=self.remat)
        fakes = {name: out[b] for b, name in self.branches.items()}
        reals = {name: batch[name] for name in fakes}
        if "S" in fakes:
            fakes["S"] = fakes["S"].expand(-1, 3, -1, -1)
            reals["S"] = reals["S"].expand(-1, 3, -1, -1)
        hazy = batch["B"]
        losses = {}
        for name, fake in fakes.items():
            real, lk = reals[name], name.lower()
            pred = functional_call(self.d[name], self._cast(self.d[name]),
                                   (torch.cat([hazy, fake], dim=1),))
            losses[f"GAN_{lk}"] = gan_loss(pred, True, self.use_lsgan) * 0.0618
            losses[f"vgg_{lk}"] = (vgg_perceptual_loss(self.vgg, fake, real)
                                   * cfg.lambda_vgg * 2)
            losses[f"gradient_fake_{lk}"] = torch.mean(torch.square(
                color_gradient(real) - color_gradient(fake))) * 2
            losses[f"L2_{lk}"] = torch.mean(torch.abs(real - fake)) * 2
            losses[f"ssim_{lk}"] = (1.0 - ssim(real, fake)) * 3
        losses["p"] = idmrf_loss(self.vgg, reals["A"], fakes["A"]) * 0.06
        losses["s"] = semantic_consistency_loss(self.vgg, reals["A"],
                                                fakes["A"]) * 2
        losses = {k: v.float() for k, v in losses.items()}
        losses["G"] = sum(losses.values())
        return losses, fakes, reals

    def _d_loss(self, hazy, fakes, reals):
        losses = {}
        for name, fake in fakes.items():
            real_cat = torch.cat([hazy, reals[name].float()], dim=1)
            fake_cat = torch.cat([hazy, fake.detach().float()], dim=1)
            l_real = gan_loss(apply_d(self.d[name], real_cat), True,
                              self.use_lsgan)
            l_fake = gan_loss(apply_d(self.d[name], fake_cat), False,
                              self.use_lsgan)
            losses[f"D{name}"] = (l_real + l_fake) * 0.5
        return losses

    # -- the step -----------------------------------------------------------
    def set_input(self, batch: Dict) -> None:
        """NHWC numpy batch from the loader -> device NCHW float32 in
        [-1, 1], over the uint8 wire when that is lossless."""
        self._batch = {}
        for k, v in batch.items():
            if not isinstance(v, np.ndarray):
                continue
            t = torch.from_numpy(_u8_wire(v)).to(self.device)
            t = t.permute(0, 3, 1, 2).contiguous()
            self._batch[k] = (t.float() / 127.5 - 1.0
                              if t.dtype == torch.uint8 else t.float())
        self.image_paths = batch.get("B_paths", [])

    @torch.no_grad()
    def _init_state(self, x: torch.Tensor) -> None:
        """Data-dependent ActNorm init from the first batch (float32, all
        branches, no remat); pools shaped after it."""
        if not self.g.actnorms_ready():
            self.g(x)
        for name in self.branches.values():
            self.pools[name] = pool_init(self.cfg.pool_size, x.shape[1:],
                                         self.dtype, self.device)

    def optimize_parameters(self, cfg=None) -> None:
        batch = self._batch
        if not self.pools:
            self._init_state(batch["B"])
        g_c = self._g_compute()
        losses, fakes, reals = self._g_loss(g_c, batch)
        losses["G"].backward(inputs=list(g_c.parameters()))
        d_losses = self._d_loss(batch["B"], fakes, reals)
        sum(d_losses.values()).backward(inputs=list(self.d.parameters()))
        gl = float(losses["G"].detach())
        if math.isfinite(gl) and gl < float(self.cfg.skip_threshold):
            with torch.no_grad():
                for name, fake in fakes.items():
                    pool_query(self.pools[name], fake.detach(), self.pool_gen)
            for pc, pm in zip(g_c.parameters(), self.g.parameters()):
                pm.grad = (torch.zeros_like(pm) if pc.grad is None
                           else pc.grad.float())
            for opt in (self.g_opt, self.d_opt):
                for group in opt.param_groups:
                    group["lr"] = self.lr
                    for p in group["params"]:   # every parameter moves,
                        if p.grad is None:      # as in JAX
                            p.grad = torch.zeros_like(p)
                opt.step()
            self.step += 1
        for module in (g_c, self.g, self.d):
            module.zero_grad(set_to_none=True)
        losses.update(d_losses)
        self._losses = {k: v.detach() for k, v in losses.items()}
        self._fakes = {k: v.detach() for k, v in fakes.items()}

    # -- the reference wrapper's interface --------------------------------
    def get_current_losses(self) -> Dict[str, float]:
        return {k: float(v) for k, v in self._losses.items()}

    def get_current_visuals(self) -> Dict[str, np.ndarray]:
        def nhwc(t):
            return t.float().permute(0, 2, 3, 1).cpu().numpy()
        vis = {"real_B": nhwc(self._batch["B"])}
        for name, fake in self._fakes.items():
            vis[_VISUAL[name]] = nhwc(fake)
            if name in self._batch:
                vis[f"real_{name}"] = nhwc(self._batch[name])
        return vis

    def get_image_paths(self):
        return self.image_paths

    def save_networks(self, epoch) -> None:
        save_net(self.cfg, epoch, "G", self.g)
        for name, d in self.d.items():
            save_net(self.cfg, epoch, f"D_{name}", d)
        save_train_state(self.cfg, str(epoch), {
            "g": self.g.state_dict(),
            "d": {name: d.state_dict() for name, d in self.d.items()},
            "g_opt": self.g_opt.state_dict(), "d_opt": self.d_opt.state_dict(),
            "pool_gen": self.pool_gen.get_state(), "step": self.step})

    def update_learning_rate(self) -> None:
        self.epoch += 1
        old = self.lr
        self.lr = lr_for_epoch(self.cfg, self.epoch - self.cfg.epoch_count)
        print(f"learning rate = {self.lr:.7f} (was {old:.7f})")
