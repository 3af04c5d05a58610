"""Large-image and ensemble inference (counterpart of
cfen_vit_tpu/models/inference_utils.py), on NHWC tensors as there.

  * self_ensemble_x8: the model averaged over the 8 dihedral transforms
    (flips and transpose), each output transformed back;
  * chop_forward: overlap-tiled inference for images larger than the
    model's geometry, blended across the overlaps with a separable linear
    (Bartlett) window.

Both call `fwd` once per transform or tile.  The blend accumulates in
float32 and returns the tiles' dtype: the JAX version mixes its float32
window into bf16 tiles, which its dynamic_update_slice does not take.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def _dihedral(x: torch.Tensor, i: int) -> torch.Tensor:
    """The i-th of the 8 dihedral transforms of NHWC x."""
    if i & 1:
        x = x.flip(2)              # horizontal flip
    if i & 2:
        x = x.flip(1)              # vertical flip
    if i & 4:
        x = x.transpose(1, 2)      # transpose
    return x


def _dihedral_inv(x: torch.Tensor, i: int) -> torch.Tensor:
    if i & 4:
        x = x.transpose(1, 2)
    if i & 2:
        x = x.flip(1)
    if i & 1:
        x = x.flip(2)
    return x


def self_ensemble_x8(fwd: Callable, x: torch.Tensor) -> torch.Tensor:
    """fwd: [N,H,W,C] -> [N,H,W,C']; the mean over the 8 transforms.  The
    transpose members need H == W."""
    return sum(_dihedral_inv(fwd(_dihedral(x, i)), i) for i in range(8)) / 8.0


def _window(tile: int, overlap: int, first: bool, last: bool) -> np.ndarray:
    """Flat centre, linear ramps of `overlap` at the seams; a border tile
    keeps full weight at the image's edge."""
    w = np.ones(tile, np.float32)
    if overlap > 0:
        r = (np.arange(overlap, dtype=np.float32) + 1) / (overlap + 1)
        w[:overlap] = r
        w[-overlap:] = r[::-1]
    if first:
        w[:overlap] = 1.0
    if last:
        w[-overlap:] = 1.0
    return w


def chop_forward(fwd: Callable, x: torch.Tensor, tile: int,
                 overlap: int = 32) -> torch.Tensor:
    """Run `fwd` on overlapping `tile` x `tile` crops of NHWC x and blend.

    H and W must be at least `tile`; they need not be multiples of the
    stride (the last row and column of tiles are aligned to the far edge)."""
    n, h, w, _ = x.shape
    if tile > h or tile > w:
        raise ValueError(f"image {h}x{w} smaller than the {tile} px tile")
    stride = tile - overlap

    def starts(size):
        return list(range(0, size - tile, stride)) + [size - tile]

    ys, xs = starts(h), starts(w)
    out = weight = None
    for yi, y0 in enumerate(ys):
        wy = _window(tile, overlap, yi == 0, yi == len(ys) - 1)
        for xi, x0 in enumerate(xs):
            wx = _window(tile, overlap, xi == 0, xi == len(xs) - 1)
            tile_out = fwd(x[:, y0:y0 + tile, x0:x0 + tile])
            if out is None:
                out = torch.zeros((n, h, w, tile_out.shape[-1]),
                                  device=tile_out.device)
                weight = torch.zeros((1, h, w, 1), device=tile_out.device)
            win = torch.from_numpy(np.outer(wy, wx)).to(tile_out.device)[None, :, :, None]
            out[:, y0:y0 + tile, x0:x0 + tile] += tile_out.float() * win
            weight[:, y0:y0 + tile, x0:x0 + tile] += win
    return (out / weight).to(tile_out.dtype)
