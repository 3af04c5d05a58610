"""2x pooling and upsampling, NCHW (counterpart of cfen_vit_tpu/ops/resize.py).

  avg_pool2          <- nn.AvgPool2d(2, stride=2)
  upsample_bilinear2 <- nn.Upsample(scale_factor=2, mode='bilinear',
                        align_corners=False)
  resize_align_corners <- models/generator.py _resize_align_corners (the
                        SpatialPyramid's F.upsample_bilinear: bilinear,
                        align_corners=True, a 1x1 map broadcast)

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


def resize_align_corners(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B,C,ih,iw] -> [B,C,h,w], bilinear with align_corners=True."""
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=True)
