"""Neural-net primitives, NCHW (counterpart of cfen_vit_tpu/ops/nn.py).

Most of the JAX module's primitives are PyTorch's own modules here, with
the reference's torch weight layouts, so checkpoint tensors load as they
are (interop/from_jax.py applies the JAX package's transposes):

  JAX (ops/nn.py)            port
  conv2d                     nn.Conv2d           weight [out, in, kh, kw]
  conv_transpose2d k4 s2 p1  nn.ConvTranspose2d  weight [in, out, kh, kw]
  linear                     nn.Linear           weight [out, in]
  layer_norm (eps 1e-5)      nn.LayerNorm
  reflection_pad             F.pad(mode="reflect") / nn.ReflectionPad2d
  relu                       F.relu / nn.ReLU
  leaky_relu (slope 0.2)     F.leaky_relu(x, 0.2)

What PyTorch has no module for lives below: the instance norm with the
JAX package's f32 one-pass statistics (also as a parameter-free module,
InstanceNorm, for the Sequential slots the reference fills with
InstanceNorm2d), ActNorm2d with its data-dependent initialisation and
the JAX init pass's semantics (`actnorm_init_pass`), and iid_cnn_crs's
reflect-padded ResnetBlock.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False) on [B,C,H,W] with float32 statistics
    (E[x^2] - mu^2, floored at 0), cast back to x's dtype — as in the JAX
    package, which makes the bf16 path use f32 statistics too; float64
    keeps float64, as there."""
    x32 = x if x.dtype == torch.float64 else x.float()
    mu = x32.mean(dim=(2, 3), keepdim=True)
    var = (x32.square().mean(dim=(2, 3), keepdim=True)
           - mu.square()).clamp_min(0.0)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


class InstanceNorm(nn.Module):
    """`instance_norm` as a module without parameters or buffers: fills a
    reference Sequential slot (InstanceNorm2d(affine=False)) so the slots
    after it keep their state_dict indices."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x)


def conv_transpose_up2(cin: int, cout: int) -> nn.ConvTranspose2d:
    """The decoder's 2x upsampling conv: ConvTranspose2d(k=4, s=2, p=1)."""
    return nn.ConvTranspose2d(cin, cout, kernel_size=4, stride=2, padding=1)


class ActNorm2d(nn.Module):
    """y = (x + bias) * exp(weight) per channel (reference models/actnorm.py).

    The first forward with `initialized == 0` sets bias = -mean and
    weight = -0.5 * log(max(unbiased var, 0.2)) from that batch (float32
    statistics) and flips `initialized` to 1 — the JAX package's `ANCtx`
    init pass (generator.py ANCtx, ops/nn.py actnorm_apply).  Modules reach
    that forward in forward order, so one pass initialises all of them.
    An already-initialised module is left untouched, except inside
    `actnorm_init_pass`.
    """

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("initialized", torch.zeros((), dtype=torch.int64))
        # host copy of `initialized`, so a forward does not read the device
        # buffer (a sync) more than once after each load
        self._ready = None
        self._reinit = False    # set by actnorm_init_pass

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        self._ready = None

    @torch.no_grad()
    def _init_from(self, x: torch.Tensor) -> None:
        flat = x.transpose(0, 1).reshape(x.shape[1], -1).float()
        mean = flat.mean(dim=1)
        n = flat.shape[1]
        var = (flat - mean[:, None]).square().sum(dim=1) / max(n - 1, 1)
        self.bias.copy_(-mean)
        self.weight.copy_(-0.5 * torch.log(var.clamp_min(0.2)))
        self.initialized.fill_(1)

    def ready(self) -> bool:
        if self._ready is None:
            self._ready = bool(self.initialized)
        return self._ready

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._reinit or not self.ready():
            self._init_from(x)
            self._ready = True
        b = self.bias.to(x.dtype)[None, :, None, None]
        s = torch.exp(self.weight).to(x.dtype)[None, :, None, None]
        return (x + b) * s


@contextlib.contextmanager
def actnorm_init_pass(module: nn.Module):
    """The JAX ANCtx(init=True) pass over `module`: every ActNorm2d that is
    uninitialised on entry takes its statistics from each of its inputs
    during the block, so a module called twice in one forward (a tail that
    R and D share) normalises each call by that call's own batch, and the
    last call's statistics stay, as ANCtx.merge keeps the last update of
    a path.  A module called once behaves as outside the block."""
    fresh = [m for m in module.modules()
             if isinstance(m, ActNorm2d) and not m.ready()]
    for m in fresh:
        m._reinit = True
    try:
        yield
    finally:
        for m in fresh:
            m._reinit = False


class ResnetBlock(nn.Module):
    """iid_cnn_crs's block (JAX generator.py _resblock): x + [reflect pad 1,
    conv3x3, ActNorm, ReLU, reflect pad 1, conv3x3, ActNorm](x).  The
    reference's `conv_block` slots, so convs sit at 1 and 5, ActNorms at
    2 and 6."""

    def __init__(self, c: int):
        super().__init__()
        self.conv_block = nn.Sequential(
            nn.ReflectionPad2d(1), nn.Conv2d(c, c, 3), ActNorm2d(c), nn.ReLU(),
            nn.ReflectionPad2d(1), nn.Conv2d(c, c, 3), ActNorm2d(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv_block(x)
