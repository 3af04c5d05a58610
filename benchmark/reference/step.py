"""Frozen plain reference of the conditional-GAN step (a copy of the
loss sets and update order of the port's train/trainer.py GanTrainer),
float32, one network of each, no pools (their query answer is discarded
there) and no remat.

One step: on the first, the ActNorm init pass over the whole batch
(float32, every branch); the G loss and its grads of G only; the LS-GAN D
loss 0.5 (real + fake) on the detached fakes and its grads of the Ds;
the skip gate (isfinite(G) and G < skip_threshold); Adam (beta1, 0.999,
eps 1e-8) on G and on the Ds at `lr`.  Every parameter moves: a leaf no
loss reaches takes a zero grad, as the port gives it.

Loss sets: "dec" (dec_vit and the IID models) per branch GAN x0.0618,
VGG x2 lambda_vgg, gradient MSE x2, L1 x2 as L2_*, (1 - SSIM) x3, and on
A the ID-MRF x0.06 and the semantic consistency x2, both called as
(real, fake); "decmgvit" (dec_mgvit) per branch GAN, VGG, gradient MSE
x1, L1 x2.
"""

from __future__ import annotations

import math

import torch

from . import losses as L
from .nets import Discriminator, Generator
from .weights import build


def branch_names(spec) -> dict:
    """generator output -> its D's name; dec_ipt trains its refined dh as A."""
    names = {"d" if "d" in spec.branches else "dh": "A"}
    names.update({b: b.upper() for b in "rs" if b in spec.branches})
    return names


class RefTrainer:
    """The step over given networks: g, {A/R/S: D}, the VGG19 tower."""

    def __init__(self, spec, g, d: dict, vgg, loss_set: str, lr: float,
                 beta1: float, lambda_vgg: float, skip_threshold: float,
                 mrf_remat: bool = True):
        self.spec, self.loss_set = spec, loss_set
        self.names = branch_names(spec)
        self.g, self.d = g, torch.nn.ModuleDict(d)
        self.vgg = vgg.requires_grad_(False)
        adam = dict(lr=lr, betas=(beta1, 0.999), eps=1e-8)
        self.g_opt = torch.optim.Adam(self.g.parameters(), **adam)
        self.d_opt = torch.optim.Adam(self.d.parameters(), **adam)
        self.lambda_vgg, self.skip = lambda_vgg, skip_threshold
        self.mrf_remat = mrf_remat
        self.ready = False

    def g_loss(self, batch):
        out = self.g(batch["B"])
        fakes = {n: out[b] for b, n in self.names.items()}
        reals = {n: batch[n] for n in fakes}
        if "S" in fakes:
            fakes["S"] = fakes["S"].expand(-1, 3, -1, -1)
            reals["S"] = reals["S"].expand(-1, 3, -1, -1)
        hazy, losses = batch["B"], {}
        for n, fake in fakes.items():
            real, k = reals[n], n.lower()
            losses[f"GAN_{k}"] = L.lsgan(self.d[n](torch.cat([hazy, fake], 1)),
                                         True) * 0.0618
            losses[f"vgg_{k}"] = L.perceptual(self.vgg, fake, real) * (
                self.lambda_vgg * 2)
            losses[f"gradient_fake_{k}"] = torch.mean(torch.square(
                L.color_gradient(real) - L.color_gradient(fake))) * (
                1 if self.loss_set == "decmgvit" else 2)
            losses[f"L2_{k}"] = torch.mean(torch.abs(real - fake)) * 2
            if self.loss_set == "dec":
                losses[f"ssim_{k}"] = (1.0 - L.ssim(real, fake)) * 3
        if self.loss_set == "dec":
            losses["p"] = L.idmrf(self.vgg, reals["A"], fakes["A"],
                                  self.mrf_remat) * 0.06
            losses["s"] = L.semantic(self.vgg, reals["A"], fakes["A"]) * 2
        losses["G"] = sum(losses.values())
        return losses, fakes, reals

    def d_loss(self, hazy, fakes, reals):
        return {f"D{n}": (L.lsgan(self.d[n](torch.cat([hazy, reals[n]], 1)), True)
                          + L.lsgan(self.d[n](torch.cat([hazy, f.detach()], 1)),
                                    False)) * 0.5
                for n, f in fakes.items()}

    @classmethod
    def from_state(cls, spec, state: dict, device, **kw):
        """Networks built on `device` from one run's drawn state dicts."""
        g = build(lambda: Generator(spec), state["G"], device)
        d = {n: build(Discriminator, state["D"][n], device)
             for n in branch_names(spec).values()}
        return cls(spec, g, d, build(L.VGG19, state["VGG"], device), **kw)

    def step(self, batch: dict) -> dict:
        """One step on NCHW float32 tensors in [-1, 1]: B, A, R, S.
        Returns the losses as floats."""
        if not self.ready:
            with torch.no_grad():
                self.g(batch["B"], init=True)
            self.ready = True
        losses, fakes, reals = self.g_loss(batch)
        gp = list(self.g.parameters())
        for p, gr in zip(gp, torch.autograd.grad(losses["G"], gp,
                                                 allow_unused=True)):
            p.grad = torch.zeros_like(p) if gr is None else gr
        d_losses = self.d_loss(batch["B"], fakes, reals)
        dp = list(self.d.parameters())
        for p, gr in zip(dp, torch.autograd.grad(sum(d_losses.values()), dp,
                                                 allow_unused=True)):
            p.grad = torch.zeros_like(p) if gr is None else gr
        losses.update(d_losses)
        self.fakes = {n: f.detach() for n, f in fakes.items()}
        out = {k: float(v.detach()) for k, v in losses.items()}
        if math.isfinite(out["G"]) and out["G"] < self.skip:
            self.g_opt.step()
            self.d_opt.step()
        for p in gp + dp:
            p.grad = None
        return out

    def visuals(self) -> dict:
        """The last step's fakes as host NHWC float32, named as the port's
        get_current_visuals names them."""
        return {f"fake_{n}": f.float().permute(0, 2, 3, 1).cpu().numpy()
                for n, f in self.fakes.items()}

    def leaves(self) -> dict:
        """name -> parameter, G's as G.<name>, the Ds' as D.<A|R|S>.<name>."""
        out = {f"G.{k}": p for k, p in self.g.named_parameters()}
        out.update({f"D.{k}": p for k, p in self.d.named_parameters()})
        return out

    def optimizers(self):
        return (self.g_opt, self.d_opt)
