"""The vendored `actnorm` package's layers (counterpart of
cfen_vit_tpu/ops/actnorm_pkg.py; ref actnorm/actnorm/actnorm.py:7-55),
channels on dim 1 as in torch.

y = scale * x + bias per channel.  The first forward (or the first after
`reset_()`) sets scale = 1 / std and bias = -scale * mean from its batch,
with the biased std over every axis but the channel's; later forwards
keep them.  Nothing on the main path uses it (the generators' ActNorm is
ops/nn.py ActNorm2d, y = (x + bias) * exp(weight)).
"""

from __future__ import annotations

import torch
import torch.nn as nn


class ActNorm(nn.Module):
    ranks = None            # the input ranks a subclass accepts

    def __init__(self, num_features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.zeros(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("initialized", torch.zeros((), dtype=torch.uint8))

    def reset_(self) -> "ActNorm":
        self.initialized.zero_()
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.ranks is not None and x.dim() not in self.ranks:
            want = " or ".join(f"{r}D" for r in self.ranks)
            raise ValueError(f"expected {want} input (got {x.dim()}D input)")
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if not int(self.initialized):
            with torch.no_grad():
                flat = x.transpose(0, 1).reshape(x.shape[1], -1)
                std = flat.std(dim=1, unbiased=False)
                self.scale.copy_(1.0 / std)
                self.bias.copy_(-self.scale * flat.mean(dim=1))
                self.initialized.fill_(1)
        return self.scale.view(shape) * x + self.bias.view(shape)


class ActNorm1d(ActNorm):
    ranks = (2, 3)


class ActNorm2d(ActNorm):
    ranks = (4,)


class ActNorm3d(ActNorm):
    ranks = (5,)
