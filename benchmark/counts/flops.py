"""Model FLOPs of one timed unit (an inference batch or a training
step), counted once per cell by torch.utils.flop_counter over the frozen
plain reference on the meta device at the cell's shapes; and the shapes
of every attention call (K1's work) in the same pass.

A training step counts the generator's forward over every branch, the G
loss (the Ds, the VGG19 tower, SSIM's and the gradient's convolutions)
and its backward to G, and the D loss and its backward to the Ds: model
FLOPs, without the remat recompute, the ActNorm init pass (once a run)
or the optimizer.  Only matrix products and convolutions are counted,
as FlopCounterMode does.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference.losses import VGG19
from ..reference.nets import Discriminator, Generator, SelfAttention
from ..reference.step import RefTrainer, branch_names


def _attention_spy(module, calls):
    hooks = [m.register_forward_hook(
        lambda _m, args, _out: calls.append(tuple(args[0].shape)))
        for m in module.modules() if isinstance(m, SelfAttention)]
    return hooks


def infer_unit(spec, batch: int, side: int, branches=None) -> dict:
    """One forward at [batch, 3, side, side]: {"flops", "attention": [(n,
    s, e), ...]}."""
    with torch.device("meta"):
        g = Generator(spec)
        x = torch.empty(batch, 3, side, side)
    calls = []
    hooks = _attention_spy(g, calls)
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            g(x, branches=branches)
    finally:
        for h in hooks:
            h.remove()
    return {"flops": float(fc.get_total_flops()), "attention": calls}


def train_unit(spec, batch: int, side: int, loss_set: str) -> dict:
    """One GAN step at batch `batch`: {"flops", "attention"} (the
    forward's attention calls)."""
    with torch.device("meta"):
        g = Generator(spec)
        d = {n: Discriminator() for n in branch_names(spec).values()}
        tr = RefTrainer(spec, g, d, VGG19(), loss_set, lr=0.0, beta1=0.5,
                        lambda_vgg=1.0, skip_threshold=1e8, mrf_remat=False)
        x = {k: torch.empty(batch, 1 if k == "S" else 3, side, side)
             for k in ("B", "A", "R", "S")}
    calls = []
    hooks = _attention_spy(g, calls)
    try:
        with FlopCounterMode(display=False) as fc:
            losses, fakes, reals = tr.g_loss(x)
            gp = list(tr.g.parameters())
            torch.autograd.grad(losses["G"], gp, allow_unused=True)
            dl = tr.d_loss(x["B"], fakes, reals)
            dp = list(tr.d.parameters())
            torch.autograd.grad(sum(dl.values()), dp, allow_unused=True)
    finally:
        for h in hooks:
            h.remove()
    return {"flops": float(fc.get_total_flops()), "attention": calls}
