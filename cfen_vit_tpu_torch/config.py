"""Command-line configuration and device selection for the port.

The flags are the JAX package's (cfen_vit_tpu/config.py `Config`), parsed
by its own `parse_args`.  That function also turns on JAX's persistent
compilation cache, which imports jax; the port parses with that one step
switched off and imports no JAX.
"""

from __future__ import annotations

from typing import List, Optional
from unittest import mock

import torch

from cfen_vit_tpu import config as _config


def parse_args(argv: Optional[List[str]] = None,
               is_train: bool = False) -> _config.Config:
    with mock.patch.object(_config, "enable_compilation_cache",
                           lambda *args, **kwargs: None):
        return _config.parse_args(argv, is_train=is_train)


def select_device(gpu_ids: str) -> torch.device:
    """`--gpu_ids`: "-1" is the CPU, "N" is cuda:N.  Asking for a card that
    torch cannot see raises; nothing falls back to the CPU."""
    ids = [int(i) for i in str(gpu_ids).split(",") if i.strip()]
    if not ids or ids[0] < 0:
        return torch.device("cpu")
    if len(ids) > 1:
        raise ValueError(f"--gpu_ids {gpu_ids}: the port runs on one card")
    if not torch.cuda.is_available():
        raise RuntimeError(f"--gpu_ids {gpu_ids} asks for CUDA, but "
                           "torch.cuda.is_available() is False; pass "
                           "--gpu_ids -1 for the CPU")
    return torch.device("cuda", ids[0])


def set_precision(precision: str) -> None:
    """`--precision highest` (the default) keeps float32 convolutions and
    matmuls in full float32 on the card: TF32 off for cuDNN and cuBLAS."""
    tf32 = precision != "highest"
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
