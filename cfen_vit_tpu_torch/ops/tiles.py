"""Tile split/join for the batched local ViT, NCHW (counterpart of
cfen_vit_tpu/ops/tiles.py).

The reference quarters each map with Crop2x2 and runs the shared-weight
LViT once per tile; the tiles are disjoint, so one batched call on
[B*T, C, t, t] is exact.  Tiles are row-major over the tile grid.
"""

from __future__ import annotations

import torch


def split_tiles(x: torch.Tensor, t: int) -> torch.Tensor:
    """[B,C,H,W] -> [B*(H/t)*(W/t), C, t, t], row-major tile order."""
    b, c, h, w = x.shape
    gh, gw = h // t, w // t
    x = x.reshape(b, c, gh, t, gw, t).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b * gh * gw, c, t, t)


def join_tiles(x: torch.Tensor, b: int, h: int, w: int) -> torch.Tensor:
    """Inverse of split_tiles: [B*T, C, t, t] -> [B,C,H,W]."""
    _, c, t, _ = x.shape
    gh, gw = h // t, w // t
    x = x.reshape(b, gh, gw, c, t, t).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(b, c, h, w)
