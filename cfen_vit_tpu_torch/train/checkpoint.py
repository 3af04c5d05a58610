"""Checkpoint save and load (counterpart of
cfen_vit_tpu/train/checkpoint.py).

Networks are `<checkpoints_dir>/<name>/<epoch>_net_<net>.pth` state_dicts,
the reference's naming, so `--which_epoch N` and `latest` resolve as in
the JAX package and `load_net` reads them back strictly.  The training
state (`<tag>_train_state.pt`) adds the Adam moments and step counts and
the ImagePool generator's state, so a resumed run continues exactly; the
pools themselves are not kept (the JAX package keeps none either).

`load_net` also reads the JAX package's `<epoch>_net_<net>.msgpack` (its
native format, flax msgpack of the param tree) where no `.pth` is in the
slot: interop/flax_msgpack.py decodes it without flax, the bridge of
interop/from_jax.py for the module's kind maps it to the port's keys, and
it loads strictly.  The JAX `<tag>_train_state.msgpack` (optax moments,
the PRNG key) is not read: `--continue_train` needs the port's `.pt`.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch
import torch.nn as nn

from ..interop import flax_msgpack
from ..interop.from_jax import module_state_dict_from_jax
from ..interop.torch_import import load_reference_state_dict


def _path(cfg, epoch, net_name, ext):
    return os.path.join(cfg.checkpoints_dir, cfg.name,
                        f"{epoch}_net_{net_name}.{ext}")


def save_net(cfg, epoch, net_name: str, model: nn.Module) -> str:
    path = _path(cfg, epoch, net_name, "pth")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(model.state_dict(), path)
    return path


def load_net(cfg, epoch, net_name: str, model: nn.Module) -> None:
    """Load `<epoch>_net_<net_name>.pth` into `model` (strict, dead
    reference tensors dropped), else the JAX package's `.msgpack` of that
    slot through the weight bridge (strict)."""
    pth = _path(cfg, epoch, net_name, "pth")
    if os.path.exists(pth):
        sd = torch.load(pth, map_location="cpu", weights_only=True)
        load_reference_state_dict(model, sd)
        return
    mp = _path(cfg, epoch, net_name, "msgpack")
    if os.path.exists(mp):
        tree = flax_msgpack.as_numpy(flax_msgpack.load(mp))
        load_reference_state_dict(model, module_state_dict_from_jax(tree, model))
        return
    raise FileNotFoundError(
        f"no checkpoint for epoch '{epoch}' net '{net_name}' under "
        f"{os.path.dirname(pth)} (looked for .pth and .msgpack)")


def _state_path(cfg, tag) -> str:
    return os.path.join(cfg.checkpoints_dir, cfg.name,
                        f"{tag}_train_state.pt")


def save_train_state(cfg, tag: str, state: dict) -> str:
    path = _state_path(cfg, tag)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(state, path)
    return path


def load_train_state(cfg, tag: str, device=None) -> dict:
    path = _state_path(cfg, tag)
    if not os.path.exists(path):
        jax_state = path[:-len(".pt")] + ".msgpack"
        extra = (f"; {jax_state} is the JAX package's train state (optax "
                 "moments, PRNG key), which the port does not read: load its "
                 "nets with --which_epoch and train without --continue_train"
                 if os.path.exists(jax_state) else "")
        raise FileNotFoundError(f"--continue_train: {path} not found{extra}")
    return torch.load(path, map_location=device, weights_only=True)


def latest_epoch(cfg, net_name: str = "G") -> Optional[str]:
    d = os.path.join(cfg.checkpoints_dir, cfg.name)
    if not os.path.isdir(d):
        return None
    eps = []
    for f in os.listdir(d):
        m = re.match(rf"(\w+)_net_{net_name}\.(msgpack|pth)$", f)
        if m and m.group(1).isdigit():
            eps.append(int(m.group(1)))
    return str(max(eps)) if eps else None
