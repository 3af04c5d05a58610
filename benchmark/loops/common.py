"""What the two loops share: the port's Config for a cell, the plain
reference's generator spec and arithmetic, set-up stages on standard
error."""

from __future__ import annotations

import contextlib
import sys
import time

import torch

from ..reference import lowp
from ..reference.nets import gen_spec


def program_config(config: dict, mix: dict, device, is_train: bool,
                   **options):
    """The port's Config of a cell: the configuration's widths, the mix's
    batch and arithmetic, `options` for the rest."""
    from cfen_vit_tpu_torch.config import Config
    cfg = Config(
        model=config["model"], model_G=config["model_G"],
        n_feats=config["n_feats"], hidden_dim_ratio=config["hidden_dim_ratio"],
        patch_size=config["patch_size"], patch_dim=config["patch_dim"],
        num_heads=config["num_heads"], num_layers=config["num_layers"],
        loadSize=config["loadSize"], batchSize=mix["batch"],
        compute_dtype=mix["compute_dtype"], precision=mix["precision"],
        gpu_ids="-1" if device.type == "cpu" else str(device.index or 0),
        **options)
    cfg.isTrain = is_train
    cfg.validate()
    return cfg


def ref_spec(config: dict):
    return gen_spec(config["model_G"], config["spec"], n_feats=config["n_feats"],
                    hidden_dim_ratio=config["hidden_dim_ratio"],
                    patch_size=config["patch_size"],
                    patch_dim=config["patch_dim"],
                    num_heads=config["num_heads"], load_size=config["loadSize"])


def stage(t0: float, name: str) -> None:
    """A set-up stage's end, in seconds since the process started, on
    standard error (where set-up goes, for PERF.md)."""
    print(f"stage {name} {time.perf_counter() - t0:.3f}", file=sys.stderr)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def plain(control=None):
    """The reference's arithmetic inside the block: float32 with TF32 off,
    or with `control` ("tf32", "fp8") every product rounded one precision
    below (reference/lowp.py)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with lowp.LowPrecision(control) if control else contextlib.nullcontext():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
