"""Patchify/unpatchify as reshapes, NCHW (counterpart of
cfen_vit_tpu/ops/patch.py).

The reference tokenises with F.unfold(x, p, stride=p): tokens row-major
over the patch grid, each a (C, py, px) flatten, C-major.  With stride ==
kernel there is no overlap, so unfold and fold are exact permutes.
"""

from __future__ import annotations

import torch


def unfold_tokens(x: torch.Tensor, p: int) -> torch.Tensor:
    """[N,C,H,W] -> [N, (H/p)*(W/p), C*p*p] with torch-unfold token layout."""
    n, c, h, w = x.shape
    gh, gw = h // p, w // p
    x = x.reshape(n, c, gh, p, gw, p).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(n, gh * gw, c * p * p)


def fold_tokens(x: torch.Tensor, p: int, h: int, w: int) -> torch.Tensor:
    """Inverse of unfold_tokens: [N, L, C*p*p] -> [N,C,H,W]."""
    n, _, d = x.shape
    gh, gw = h // p, w // p
    c = d // (p * p)
    x = x.reshape(n, gh, gw, c, p, p).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(n, c, h, w)
