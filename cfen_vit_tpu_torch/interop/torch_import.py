"""Loads reference `.pth` state_dicts into the port (counterpart of
cfen_vit_tpu/interop/torch_import.py).

The port's modules carry the reference's key names, so the only work is to
drop what the reference stores but never uses in its forward, and load the
rest with strict=True:

  * `*.decoder.*` and `*.query_embed.*`: the TransformerDecoder and query
    embedding each ViT builds and never calls (ref v3:1116-1122);
  * `*.position_ids`: the position-index buffers;
  * `sub_mean.*`, `add_mean.*`: the MeanShift layers (ref v3:120-121).

Every spec family stores these same dead tensors (JAX
interop/torch_import.py reads none of them): the MeanShift pair, and in
each of its LViT/GViT blocks the decoder, query_embed (where the block has
an MLP) and position_ids (where it has positions); iid_cnn_crs has no ViT.
A `module.` (DataParallel) prefix is stripped as the reference does.
"""

from __future__ import annotations

from typing import Mapping

import torch.nn as nn


def _dead(key: str) -> bool:
    return (".decoder." in key or ".query_embed." in key
            or key.endswith(".position_ids")
            or key.startswith(("sub_mean.", "add_mean.")))


def live_state_dict(sd: Mapping) -> dict:
    """Reference state_dict -> the tensors the port's modules own."""
    out = {}
    for k, v in sd.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if not _dead(k):
            out[k] = v
    return out


def load_reference_state_dict(model: nn.Module, sd: Mapping) -> None:
    model.load_state_dict(live_state_dict(sd), strict=True)
