"""Network introspection for --verbose (counterpart of
cfen_vit_tpu/utils/netinfo.py; ref base_model.py:134-145): each network's
structure to depth 2 with the count under each entry, then its total.

The counts are of every tensor of the state_dict, parameters and buffers,
as the JAX package counts every leaf of its param tree: its ActNorms'
`initialized` flags are leaves there and buffers here, one element each.
"""

from __future__ import annotations

import torch.nn as nn


def count_params(module: nn.Module) -> int:
    return sum(t.numel() for t in module.state_dict().values())


def _structure_lines(module: nn.Module, depth: int = 0,
                     max_depth: int = 2) -> list:
    lines = []
    last = depth + 1 >= max_depth
    own = list(module.named_parameters(recurse=False)) + list(
        module.named_buffers(recurse=False))
    for name, t in own:
        lines.append(f"{'  ' * depth}{name}: {t.numel():,} params")
    for name, child in module.named_children():
        if last:
            lines.append(f"{'  ' * depth}{name}: {count_params(child):,} params")
        else:
            lines.append(f"{'  ' * depth}{name}/")
            lines += _structure_lines(child, depth + 1, max_depth)
    return lines


def print_networks(nets: dict, verbose: bool = False) -> None:
    """nets: {'G': module, 'D_A': module, ...}."""
    print("---------- Networks initialized -------------")
    for name, net in nets.items():
        if verbose:
            for line in _structure_lines(net):
                print(line)
        print(f"[Network {name}] Total number of parameters : "
              f"{count_params(net) / 1e6:.3f} M")
    print("-----------------------------------------------")
