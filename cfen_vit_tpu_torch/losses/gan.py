"""GAN loss (counterpart of cfen_vit_tpu/losses/gan.py; ref
models/networks.py:119-138).

LS-GAN by default: MSE against a 1.0/0.0 target; BCE when `--no_lsgan`
(the discriminator then outputs sigmoid probabilities).
"""

from __future__ import annotations

import torch


def gan_loss(pred: torch.Tensor, target_is_real: bool,
             use_lsgan: bool = True) -> torch.Tensor:
    target = 1.0 if target_is_real else 0.0
    if use_lsgan:
        return torch.mean(torch.square(pred - target))
    eps = 1e-12
    p = pred.clamp(eps, 1.0 - eps)
    return -torch.mean(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))
