"""Model FLOPs of one EPDN GAN step, counted once per cell by
torch.utils.flop_counter over the plain reference (reference/epdn.py) on
the meta device at the cell's shapes: the LocalEnhancer's forward, D on
the fake pair and on the real pair (once, as pix2pixHD runs it), the
VGG19 of the enhanced output and of the clear image, G's backward, D on
the pooled pair and the D loss's backward.  Only matrix products and
convolutions are counted, as FlopCounterMode does; the optimizer and the
pool are not.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import epdn as E
from ..reference.losses import VGG19


def train_unit(config: dict, batch: int, side: int) -> dict:
    """{"flops"} of one step at batch `batch` of side x side pairs."""
    with torch.device("meta"):
        tr = E.RefEpdn(config, E.LocalEnhancer(config),
                       E.MultiscaleDiscriminator(config), VGG19(),
                       E.Pool(0, None), lr=0.0, beta1=0.5)
        hazy, real = (torch.empty(batch, 3, side, side) for _ in range(2))
    with FlopCounterMode(display=False) as fc:
        g, d = tr.losses(hazy, real)
        torch.autograd.grad(sum(g.values()), list(tr.g.parameters()))
        torch.autograd.grad(0.5 * (d["D_fake"] + d["D_real"]),
                            list(tr.d.parameters()))
    return {"flops": float(fc.get_total_flops())}
