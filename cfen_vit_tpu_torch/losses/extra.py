"""Auxiliary losses of the reference's util/ (counterpart of
cfen_vit_tpu/losses/extra.py), NCHW; no trainer calls them, in either
package.

  * adain      <- util/adain.py:4-24: content statistics re-normalised to
                  the style's per (n, c), eps 2.3e-8 inside the sqrt;
  * mind       <- util/mindloss.py:5-97: the MIND self-similarity
                  descriptor of a 1-channel image: squared differences to
                  its nl x nl shifts, summed over a patch with the
                  reference's weights exp(-distance / sigma^2), normalised
                  by the variance (unbiased) of the 3 x 3 neighbourhood's
                  box-summed shifts;
  * mind_loss  <- util/mindloss.py:98-113: sum |mind(a) - mind(b)| over
                  H x W x nl^2.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def adain(x: torch.Tensor, y: torch.Tensor, eps: float = 2.3e-8):
    """x: content [N,C,H,W], y: style [N,C,H,W] -> x re-styled."""
    def mu(t):
        return t.mean(dim=(2, 3), keepdim=True)

    def sigma(t):
        return torch.sqrt(torch.square(t - mu(t)).sum(dim=(2, 3), keepdim=True)
                          / (t.shape[2] * t.shape[3]) + eps)

    return sigma(y) * (x - mu(x)) / sigma(x) + mu(y)


def _shifts(x: torch.Tensor, k: int) -> torch.Tensor:
    """Every k x k shift of a 1-channel map, zero-padded: [N,1,H,W] ->
    [N,k*k,H,W]; channel i is the shift (i % k, i // k) in (row, column),
    the reference's one-hot image_shifter weights t[0, i % k, i // k]."""
    r = (k - 1) // 2
    xp = F.pad(x[:, 0], (r, r, r, r))
    h, w = x.shape[2], x.shape[3]
    return torch.stack([xp[:, i % k:i % k + h, i // k:i // k + w]
                        for i in range(k * k)], dim=1)


def _patch_sum(d: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """A depthwise convolution of every channel with the p x p weights."""
    c, p = d.shape[1], weights.shape[0]
    k = weights.to(d.dtype)[None, None].expand(c, 1, p, p)
    return F.conv2d(d, k, padding=(p - 1) // 2, groups=c)


def _gaussian(p: int, sigma2: float, device) -> torch.Tensor:
    cx = (p - 1) // 2
    g = [[math.exp(-math.sqrt((i - cx) ** 2 + (j - cx) ** 2) / sigma2)
          for j in range(p)] for i in range(p)]
    return torch.tensor(g, device=device)


def mind(x: torch.Tensor, nl_size: int = 9, patch_size: int = 7,
         neighbor_size: int = 3, sigma: float = 3.0) -> torch.Tensor:
    """MIND descriptor of [N,1,H,W] -> [N,nl^2,H,W]."""
    shifted = _shifts(x, nl_size)
    dx_alpha = _patch_sum(torch.square(shifted - x),
                          _gaussian(patch_size, sigma * sigma, x.device))
    neigh_sum = _patch_sum(_shifts(x, neighbor_size),
                           torch.ones(patch_size, patch_size, device=x.device))
    vx = neigh_sum.var(dim=1, keepdim=True, unbiased=True)
    nume = torch.exp(-dx_alpha / (vx + 1e-8))
    return nume / nume.sum(dim=1, keepdim=True)


def mind_loss(pred: torch.Tensor, target: torch.Tensor, nl_size: int = 9,
              **kw) -> torch.Tensor:
    m1 = mind(pred, nl_size=nl_size, **kw)
    m2 = mind(target, nl_size=nl_size, **kw)
    return (m1 - m2).abs().sum() / (pred.shape[2] * pred.shape[3]
                                    * nl_size * nl_size)
