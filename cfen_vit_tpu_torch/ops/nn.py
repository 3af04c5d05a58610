"""Neural-net primitives, NCHW (counterpart of cfen_vit_tpu/ops/nn.py).

Most of the JAX module's primitives are PyTorch's own modules here, with
the reference's torch weight layouts, so checkpoint tensors load as they
are (interop/from_jax.py applies the JAX package's transposes):

  JAX (ops/nn.py)            port
  conv2d                     nn.Conv2d           weight [out, in, kh, kw]
  conv_transpose2d k4 s2 p1  nn.ConvTranspose2d  weight [in, out, kh, kw]
  linear                     nn.Linear           weight [out, in]
  layer_norm (eps 1e-5)      nn.LayerNorm
  reflection_pad             F.pad(mode="reflect")
  relu                       F.relu / nn.ReLU

What PyTorch has no module for lives below: the instance norm with the
JAX package's f32 one-pass statistics, and ActNorm2d with its
data-dependent initialisation.
"""

from __future__ import annotations

import torch
import torch.nn as nn


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False) on [B,C,H,W] with float32 statistics
    (E[x^2] - mu^2, floored at 0), cast back to x's dtype — as in the JAX
    package, which makes the bf16 path use f32 statistics too."""
    x32 = x.float()
    mu = x32.mean(dim=(2, 3), keepdim=True)
    var = (x32.square().mean(dim=(2, 3), keepdim=True)
           - mu.square()).clamp_min(0.0)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


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
    An already-initialised module is left untouched.
    """

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("initialized", torch.zeros((), dtype=torch.int64))
        # host copy of `initialized`, so a forward does not read the device
        # buffer (a sync) more than once after each load
        self._ready = None

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
        if not self.ready():
            self._init_from(x)
            self._ready = True
        b = self.bias.to(x.dtype)[None, :, None, None]
        s = torch.exp(self.weight).to(x.dtype)[None, :, None, None]
        return (x + b) * s
