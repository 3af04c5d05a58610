"""`--model_G` registry (counterpart of cfen_vit_tpu/models/registry.py).

The same names and variant switches as the JAX package, so a spec resolves
the same way in both; models/generator.py builds only the v3 structure and
raises NotImplementedError for the others (ROADMAP Queue A item 6).
"""

from __future__ import annotations

from dataclasses import replace

from .generator import GenSpec

_REGISTRY = {}


def _reg(name: str, **kw):
    _REGISTRY[name] = GenSpec(name=name, **kw)


_reg("iid_hlgvit_crs_gd4_cfs_v3", half_res_trunk=True, d_skip="cfs")
_reg("iid_hlgvit_crs_gd4_cfs", half_res_trunk=False, d_skip="cfs",
     shared_tails=True)
_reg("iid_hlgvit_crs_gd4_cfs_v2", half_res_trunk=False, d_skip="cfs",
     shared_tails=True)
_reg("iid_hlgvit_crs_gd4_cfs_pe", half_res_trunk=False, d_skip="cfs",
     shared_tails=True)
_reg("iid_hlgvit_crs_gd4_cfs_v5", half_res_trunk=True, d_skip="cfs", shrink=4)
_reg("iid_hlgvit_crs_gd4", half_res_trunk=False, d_skip="cat3",
     shared_tails=True)
_reg("iid_hlgvit_add_gd4", half_res_trunk=False, d_skip="cat3",
     fusion="add", shared_tails=True, tail_norm="instance",
     s_tail_norm=True, d02_us_from_s=True)
_reg("iid_hlgvit_crs_gd2", half_res_trunk=False, d_skip="cat3",
     global_pools=1, shared_tails=True, tail_norm="instance",
     s_tail_norm=True, d02_us_from_s=True)
_reg("iid_lvit_crs_gd4", half_res_trunk=False, d_skip="cat3",
     use_global=False, shared_tails=True, s_tail_norm=True,
     sk_conv_transposed=True, d02_us_from_s=True)
_reg("iid_gvit_crs_gd4", half_res_trunk=False, d_skip="cat3",
     use_local=False, shared_tails=True, s_tail_norm=True,
     sk_conv_transposed=True, d02_us_from_s=True)
_reg("iid_vit_crs_gd4", half_res_trunk=False, d_skip="cat3",
     use_local=False, global_pools=0, shared_tails=True, s_tail_norm=True,
     sk_conv_transposed=True, d02_us_from_s=True)
_reg("iid_cnn_crs", half_res_trunk=False, d_skip="cat3",
     use_local=False, use_global=False, shared_tails=True, cnn=True,
     ds_norm="actnorm", d02_us_from_s=True)
_reg("iidr_hlgvit_crs_gd4", half_res_trunk=False, branches="rd",
     d_skip="cat_partner", shared_tails=True, lgcat_norm="instance",
     xdh=True, tail_norm="instance", s_tail_norm=True)
_reg("iids_hlgvit_crs_gd4", half_res_trunk=False, branches="sd",
     d_skip="cat_partner", shared_tails=True, lgcat_norm="instance",
     xdh=True, tail_norm="instance", s_tail_norm=True)
_reg("iidn_hlgvit_crs_gd4", half_res_trunk=False, branches="d",
     d_skip="enc", s_tail_norm=True)
_reg("ipt", half_res_trunk=False, branches="d", fusion="add",
     d_skip="res", ipt_style=True, tail_norm="instance", s_tail_norm=True)
_reg("lgvit_add", half_res_trunk=False, branches="d", fusion="add",
     d_skip="res", ipt_style=True, tail_norm="instance", s_tail_norm=True)
_reg("dec_ipt", half_res_trunk=False, branches="rs", fusion="add",
     d_skip="res", ipt_style=True, separate_encoders=True, xdh=True,
     s_dec_from_r_enc=True, s_dec1_ru_zero=True,
     tail_norm="instance", s_tail_norm=True)


def generator_spec(name: str, cfg=None) -> GenSpec:
    """Resolve a `--model_G` name, with geometry overridden from cfg."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown --model_G '{name}'; known: "
                       f"{sorted(_REGISTRY)}")
    spec = _REGISTRY[name]
    if cfg is not None:
        spec = replace(
            spec,
            n_feats=cfg.n_feats, n_colors=cfg.n_colors,
            patch_size=cfg.patch_size, patch_dim=cfg.patch_dim,
            num_heads=cfg.num_heads, num_layers=cfg.num_layers,
            hidden_dim_ratio=cfg.hidden_dim_ratio, load_size=cfg.loadSize,
            no_norm=cfg.no_norm, no_mlp=cfg.no_mlp,
            pos_every=cfg.pos_every, no_pos=cfg.no_pos)
        if name == "lgvit_add":
            ratio = int(getattr(cfg, "l2g_ratio", 4))
            spec = replace(spec, global_pools={2: 1, 4: 2}[ratio])
    return spec
