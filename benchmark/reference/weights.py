"""Seeded weights, drawn on the device in a few large calls, in the
reference checkpoints' naming: the same state dicts go to the program and
to the plain reference.

Distributions are the port's `init_weights` / `define_d` / `vgg19_init`
ones: kaiming-normal (fan_in = weight[0].numel(), as torch counts it)
for convs, transposed convs and linears, zero biases, in_proj
U(+-1/sqrt(E)), N(0, 1) positions, unit LayerNorms, and ActNorms left
uninitialised (weight 0, bias 0, `initialized` 0) for the data-dependent
init pass.  Each network draws from its own torch.Generator, seeded from
(seed, network), so adding a network changes no other's weights.
"""

from __future__ import annotations

import math
import zlib

import torch
import torch.nn as nn

from .losses import VGG19
from .nets import ActNorm2d, Discriminator, Generator, GenSpec, SelfAttention


def stream_seed(seed: int, name: str) -> int:
    """A generator seed for (run seed, network name): any whole seed,
    negative or past 64 bits, maps into torch's range."""
    return (int(seed) * 1_000_003 + zlib.crc32(name.encode())) % (2 ** 63)


def _plan(module: nn.Module):
    """name -> ("normal", std) | ("uniform", bound) | ("const", value)."""
    plan = {}
    for mname, m in module.named_modules():
        pre = f"{mname}." if mname else ""
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            plan[pre + "weight"] = ("normal", math.sqrt(2.0 / m.weight[0].numel()))
            if m.bias is not None:
                plan[pre + "bias"] = ("const", 0.0)
        elif isinstance(m, nn.LayerNorm):
            plan[pre + "weight"] = ("const", 1.0)
            plan[pre + "bias"] = ("const", 0.0)
        elif isinstance(m, nn.Embedding):
            plan[pre + "weight"] = ("normal", 1.0)
        elif isinstance(m, SelfAttention):
            e = m.in_proj_weight.shape[1]
            plan[pre + "in_proj_weight"] = ("uniform", 1.0 / math.sqrt(e))
        elif isinstance(m, ActNorm2d):
            for k in ("weight", "bias", "initialized"):
                plan[pre + k] = ("const", 0.0)
    return plan


def draw(module: nn.Module, seed: int, name: str, device) -> dict:
    """A state dict for `module` (any device, meta included) drawn on
    `device`: one normal and one uniform draw for the whole network."""
    shapes = {k: (v.shape, v.dtype) for k, v in module.state_dict().items()}
    plan = _plan(module)
    missing = set(shapes) - set(plan)
    if missing:
        raise KeyError(f"{name}: no distribution for {sorted(missing)[:5]}")
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, name))
    out = {}
    for kind in ("normal", "uniform"):
        keys = [k for k in shapes if plan[k][0] == kind]
        sizes = [shapes[k][0].numel() for k in keys]
        if not keys:
            continue
        flat = (torch.randn if kind == "normal" else torch.rand)(
            sum(sizes), generator=gen, device=device)
        scale = torch.repeat_interleave(
            torch.tensor([plan[k][1] for k in keys], device=device),
            torch.tensor(sizes, device=device), output_size=sum(sizes))
        flat = flat * scale if kind == "normal" else (flat * 2 - 1) * scale
        for k, part in zip(keys, flat.split(sizes)):
            out[k] = part.view(shapes[k][0])
    for k, (shape, dtype) in shapes.items():
        if plan[k][0] == "const":
            out[k] = torch.full(shape, plan[k][1], dtype=dtype, device=device)
    return out


def draw_all(spec: GenSpec, d_names, seed: int, device) -> dict:
    """{"G": ..., "D": {name: ...}, "VGG": ...} for one run."""
    with torch.device("meta"):
        g, d, vgg = Generator(spec), Discriminator(), VGG19()
    return {"G": draw(g, seed, "G", device),
            "D": {n: draw(d, seed, f"D_{n}", device) for n in d_names},
            "VGG": draw(vgg, seed, "VGG19", device)}


def build(factory, state: dict, device) -> nn.Module:
    """`factory()` built on the meta device, materialised on `device` and
    filled from a full state dict."""
    with torch.device("meta"):
        m = factory()
    m = m.to_empty(device=device)
    m.load_state_dict(state, strict=True)
    return m
