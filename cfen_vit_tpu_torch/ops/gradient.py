"""Color-gradient op mirroring the reference's GradientColor_Net
(counterpart of cfen_vit_tpu/ops/gradient.py).

Per-RGB-channel central differences with the reference's fixed 3x3 +-1
kernels and padding 2 (so the output is H+2 x W+2), then
sqrt(gx^2 + gy^2 + 1e-6) per channel.  The two shifts are computed
directly instead of six single-channel convolutions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def color_gradient(x: torch.Tensor) -> torch.Tensor:
    """x: [N,C,H,W] -> [N,C,H+2,W+2] gradient magnitude per channel."""
    xp = F.pad(x, (2, 2, 2, 2))
    gv = xp[:, :, 2:, 1:-1] - xp[:, :, :-2, 1:-1]
    gh = xp[:, :, 1:-1, 2:] - xp[:, :, 1:-1, :-2]
    return torch.sqrt(gv * gv + gh * gh + 1e-6)
