"""Seeded hazy scenes through the atmospheric scattering model
I = J t + A (1 - t) (the scene maker of chip_smoke.py `write_hazy_pngs`,
kept as arrays and made on the device in a few calls): a smooth scene J
bilinearly upsampled from a 16x16 grid of uniform colours, a smooth
transmission t in [0.3, 0.9], airlight A = 0.9 and noise of 0.01, each
quantised to uint8 as the PNGs were (truncating).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def scenes(n: int, side: int, seed: int, device) -> dict:
    """{"hazy", "clear", "t"}: uint8 [n, side, side, 3] tensors on `device`
    (t grey, repeated over the three channels).  One seed gives the same
    arrays on one device; every image is drawn apart."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    low = torch.rand((n, 4, 16, 16), generator=gen, device=device)
    up = F.interpolate(low, size=(side, side), mode="bilinear",
                       align_corners=False).permute(0, 2, 3, 1)
    scene, t = up[..., :3], 0.3 + 0.6 * up[..., 3:]
    noise = torch.randn((n, side, side, 3), generator=gen, device=device)
    hazy = scene * t + 0.9 * (1 - t) + noise * 0.01

    def u8(v):
        return (v * 255).clamp(0, 255).to(torch.uint8)
    return {"hazy": u8(hazy), "clear": u8(scene), "t": u8(t.expand_as(scene))}


def loader_floats(u8: torch.Tensor, grey: bool = False) -> torch.Tensor:
    """uint8 NHWC -> the data loader's float32 in [-1, 1] (v / 255 * 2 - 1);
    `grey` reduces to its 1-channel luma 0.299 / 0.587 / 0.114, as the
    loader does for S."""
    a = u8.float() / 255.0 * 2.0 - 1.0
    if grey:
        a = (a[..., 0] * 0.299 + a[..., 1] * 0.587 + a[..., 2] * 0.114)[..., None]
    return a
