"""Tiny geometries of the benchmark's cells, for CPU tests."""

from __future__ import annotations

import copy

import torch

from benchmark.run import Cell, ROOT, load_json

GEOMETRY = {"iid_hlgvit_crs_gd4_cfs_v3": dict(loadSize=64, image_side=128),
            "dec_ipt": dict(loadSize=64, image_side=64)}

# DECMGVIT (--model dec_mgvit, the dec_ipt generator and its loss set):
# no cell of BENCHMARK.json runs it, the reference keeps its path for a
# later cell, and the tests hold that path against the port by a
# training cell's mix on this configuration
DEC_MGVIT = {
    "model": "dec_mgvit", "model_G": "dec_ipt", "loss_set": "decmgvit",
    "spec": {"half_res_trunk": False, "branches": "rs", "fusion": "add",
             "d_skip": "res", "ipt_style": True, "separate_encoders": True,
             "xdh": True, "s_dec_from_r_enc": True, "s_dec1_ru_zero": True,
             "tail_norm": "instance", "s_tail_norm": True},
    "patch_dim": 2, "num_layers": 1, "ndf": 32}
MGVIT_CELL = "mgvit_train_b4_fp32"


def tiny_cell(name: str) -> Cell:
    """A cell of BENCHMARK.json at a tiny geometry; MGVIT_CELL is
    v3_train_b4_fp32's mix and limits on DEC_MGVIT."""
    manifest = load_json(ROOT / "BENCHMARK.json")
    cell = Cell("v3_train_b4_fp32" if name == MGVIT_CELL else name, manifest)
    cfg = copy.deepcopy(DEC_MGVIT if name == MGVIT_CELL else cell.config)
    cfg.update(n_feats=8, patch_size=8, num_heads=2, hidden_dim_ratio=2,
               **GEOMETRY[cfg["model_G"]])
    mix = dict(cell.mix, batch=2)
    mix.update({k: v for k, v in dict(pool_images=16, pool_batches=4,
                                      warm_batches=1, trace_batches=2,
                                      trace_steps=2, sample_extra=2).items()
                if k in mix})
    cell.config, cell.mix = cfg, mix
    return cell


CPU = torch.device("cpu")

# --model_G -> the configuration's switches
SWITCHES = {load_json(ROOT / c["file"])["model_G"]: load_json(ROOT / c["file"])["spec"]
            for c in load_json(ROOT / "BENCHMARK.json")["configs"]}
SWITCHES["dec_ipt"] = DEC_MGVIT["spec"]
