"""Command-line configuration and device selection for the port
(counterpart of cfen_vit_tpu/config.py).

`Config` and `parse_args` are the JAX package's, flag for flag and default
for default, so the reference's README commands parse the same way in
both packages; this copy leaves out the JAX package's persistent
compilation cache and imports nothing of it.  `Config.input_size` resolves
the generator through the port's registry.

`--gpu_ids` keeps its default of "0": every entry point runs on cuda:0
unless the caller passes `--gpu_ids -1` for the CPU (`select_device`).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass
from typing import List, Optional

import torch


@dataclass
class Config:
    # ---- core experiment ----
    dataroot: str = ""
    name: str = "experiment_name"
    checkpoints_dir: str = "./checkpoints"
    model: str = "dec_vit"            # vit | dec_vit | decr_vit | decs_vit | decn_vit | test
    model_G: str = "iid_hlgvit_crs_gd4_cfs_v3"
    dataset_mode: str = "dec_vit"     # dec_vit | vit
    phase: str = "train"
    isTrain: bool = True
    which_epoch: str = "latest"

    # ---- data ----
    batchSize: int = 1
    loadSize: int = 256               # trunk feature size; 512 inputs with half-res trunk
    fineSize: int = 128
    input_nc: int = 3
    output_nc: int = 3
    resize_or_crop: str = "resize"
    no_flip: bool = False
    sb: bool = False                  # serial (paired) batches
    nThreads: int = 0
    max_dataset_size: float = float("inf")
    which_direction: str = "AtoB"

    # ---- generator geometry (transformer) ----
    n_feats: int = 32
    n_colors: int = 3
    patch_size: int = 32              # LViT tile size
    patch_dim: int = 2                # LViT patch size (GViT uses 2*patch_dim)
    num_heads: int = 4
    num_layers: int = 1
    hidden_dim_ratio: int = 6
    l2g_ratio: int = 4
    dropout_rate: float = 0.0
    no_norm: bool = False
    no_mlp: bool = False
    pos_every: bool = False
    no_pos: bool = False
    num_queries: int = 1
    rgb_range: int = 255
    shift_mean: bool = True

    # ---- discriminator ----
    ndf: int = 32
    ngf: int = 32
    which_model_netD: str = "basic"
    n_layers_D: int = 3
    norm: str = "instance"
    no_lsgan: bool = False

    # ---- init / optim ----
    init_type: str = "kaiming"
    lr: float = 1e-4
    beta1: float = 0.5
    niter: int = 100
    niter_decay: int = 200
    epoch_count: int = 1
    lr_policy: str = "lambda"
    lr_decay_iters: int = 200
    pool_size: int = 50
    continue_train: bool = False

    # ---- loss weights ----
    lambda_A: float = 1.0
    lambda_B: float = 2.0
    lambda_identity: float = 1.0
    lambda_vgg: float = 1.0
    lambda_content: float = 1.0
    lambda_style: float = 2.0
    lambda_dehazing: float = 1.0
    lambda_DC: float = 1e-6
    lambda_TV: float = 5e-5
    no_vgg_loss: bool = False
    imagepool: bool = False

    # ---- logging / io ----
    display_freq: int = 100
    display_ncols: int = 4
    display_winsize: int = 256
    display_id: int = 0
    display_server: str = "http://localhost"
    display_port: int = 3000
    update_html_freq: int = 600
    print_freq: int = 100
    save_latest_freq: int = 5000
    save_epoch_freq: int = 1
    no_html: bool = False
    verbose: bool = False
    suffix: str = ""
    results_dir: str = "results/"
    aspect_ratio: float = 1.0
    ntest: float = float("inf")
    how_many: int = 924
    out_all: bool = False

    # ---- misc reference flags kept for CLI parity ----
    gpu_ids: str = "0"                # "-1" is the CPU, "N" is cuda:N
    max_epoch: int = 300
    current_epoch: int = 0
    seed: int = 1
    debug: bool = False
    ca_type: str = "cross_ca"
    fuse_model: str = "cat"
    hl: int = 3
    unet_layer: int = 3
    dehazing_netG: str = "local"
    epdn_ngf: int = 32
    num_D: int = 2
    lambda_feat: float = 10.0
    n_downsample_global: int = 2
    n_blocks: int = 2
    no_dropout: bool = False
    skip_threshold: float = 1e8

    # ---- framework flags (the JAX package's names) ----
    precision: str = "highest"        # highest: float32 without TF32
    param_dtype: str = "float32"
    compute_dtype: str = "float32"    # bfloat16: bf16 compute, f32 master
    mesh_shape: str = ""              # data parallel: '' the launched
                                      # world, 'N' N ranks (parallel/mesh.py)
    bench_iters: int = 20
    image_size: int = 0               # 0 => inferred from loadSize & variant trunk
    remat: bool = True                # checkpoint the generator's regions
    no_remat: bool = False            # in training; --no_remat disables
    remat_mode: str = "branch"        # level | branch (per decoder branch)
    self_ensemble: bool = False
    chop: bool = False
    chop_overlap: int = 64
    trace_dir: str = ""               # torch.profiler trace of steps 10-15
    grad_accum: int = 1               # micro-batches per step
    vgg19_npz: str = ""               # pretrained VGG19 weights (.npz, keys
                                      # conv{k}_{i}.w HWIO / .b); falls back
                                      # to $CFEN_VGG19_NPZ, then to a seeded
                                      # random tower

    # -- derived geometry --------------------------------------------------
    def trunk_size(self) -> int:
        """Feature-map side length the ViT trunk runs at (== loadSize)."""
        return int(self.loadSize)

    def input_size(self) -> int:
        """Expected input image side length for the configured generator."""
        if self.image_size:
            return int(self.image_size)
        from .models.registry import generator_spec
        spec = generator_spec(self.model_G)
        return self.trunk_size() * (2 if spec.half_res_trunk else 1)

    def validate(self) -> None:
        ts = self.trunk_size()
        if ts % (4 * self.patch_size) != 0:
            raise ValueError(
                f"loadSize={ts} must be divisible by 4*patch_size="
                f"{4 * self.patch_size} (3 encoder levels with "
                f"{self.patch_size}-px tiles)")
        if self.patch_size % self.patch_dim != 0:
            raise ValueError("patch_size must be divisible by patch_dim")
        if self.grad_accum > 1 and self.batchSize % self.grad_accum != 0:
            raise ValueError(
                f"batchSize={self.batchSize} must be divisible by "
                f"grad_accum={self.grad_accum}")

    def expr_dir(self) -> str:
        return os.path.join(self.checkpoints_dir, self.name)


_STORE_TRUE = {
    "sb", "no_flip", "no_dropout", "no_lsgan", "continue_train", "no_html",
    "verbose", "out_all", "no_norm", "no_mlp", "pos_every", "no_pos",
    "no_vgg_loss", "imagepool", "debug", "isTrain", "remat", "no_remat",
    "self_ensemble", "chop",
}


def _add_args(parser: argparse.ArgumentParser, defaults: Config,
              skip=("isTrain",)) -> None:
    for f in dataclasses.fields(Config):
        if f.name in skip:
            continue
        flag = "--" + f.name
        default = getattr(defaults, f.name)
        if f.name in _STORE_TRUE:
            parser.add_argument(flag, action="store_true", default=default)
        elif f.type in ("int", int):
            parser.add_argument(flag, type=int, default=default)
        elif f.type in ("float", float):
            parser.add_argument(flag, type=float, default=default)
        else:
            parser.add_argument(flag, type=type(default) if default is not None
                                else str, default=default)


def parse_args(argv: Optional[List[str]] = None, is_train: bool = True,
               save_opt: bool = True) -> Config:
    """argparse front-end mirroring the reference's TrainOptions /
    TestOptions.parse(); dumps the option set to
    `<checkpoints_dir>/<name>/opt.txt` as the reference does."""
    defaults = Config()
    if not is_train:
        defaults.phase = "test"
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    _add_args(parser, defaults)
    ns = parser.parse_args(argv)
    cfg = Config(**{f.name: getattr(ns, f.name, getattr(defaults, f.name))
                    for f in dataclasses.fields(Config)})
    cfg.isTrain = is_train
    if not is_train:
        # the reference's test.py forces these (ref test.py:21-23)
        cfg.sb = True
        cfg.no_flip = True
        cfg.display_id = -1
    if cfg.no_remat:
        cfg.remat = False
    if cfg.suffix:
        cfg.name = cfg.name + "_" + cfg.suffix.format(**dataclasses.asdict(cfg))
    cfg.validate()
    if save_opt:
        os.makedirs(cfg.expr_dir(), exist_ok=True)
        with open(os.path.join(cfg.expr_dir(), "opt.txt"), "wt") as fh:
            fh.write("------------ Options -------------\n")
            for k, v in sorted(dataclasses.asdict(cfg).items()):
                fh.write(f"{k}: {v}\n")
            fh.write("-------------- End ----------------\n")
    return cfg


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
