"""2x pooling and upsampling, NCHW (counterpart of cfen_vit_tpu/ops/resize.py).

  avg_pool2          <- nn.AvgPool2d(2, stride=2)
  upsample_bilinear2 <- nn.Upsample(scale_factor=2, mode='bilinear',
                        align_corners=False)

The JAX package writes the exact-2x bilinear as its [1/4, 3/4] stencil with
edge clamping; torch's own interpolate computes the same weights.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 2)


def upsample_bilinear2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)
