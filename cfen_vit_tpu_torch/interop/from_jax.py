"""Weight bridge: JAX param trees (numpy arrays) -> the port's state_dicts
(counterpart of cfen_vit_tpu/interop/torch_export.py): the generator, the
PatchGAN discriminators, the VGG19 tower and the DCNv2 Pack.

Pure numpy with the exporter's transposes (torch_export.py _conv, _convT,
_linear, _an), so it never imports the JAX package.  It writes exactly the
tensors the port's modules own: the exporter's key set minus the dead
tensors it synthesises for the reference (interop/torch_import.py lists
them).  Covers the v3 structure the port builds.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.generator import GenSpec, check_ported


def _conv(p):
    out = {"weight": np.asarray(p["w"]).transpose(3, 2, 0, 1)}
    if "b" in p:
        out["bias"] = np.asarray(p["b"])
    return out


def _convT(p):
    return {"weight": np.asarray(p["w"]).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1],
            "bias": np.asarray(p["b"])}


def _linear(p):
    out = {"weight": np.asarray(p["w"]).T}
    if "b" in p:
        out["bias"] = np.asarray(p["b"])
    return out


def _an(p):
    return {"weight": np.asarray(p["w"]), "bias": np.asarray(p["b"]),
            "initialized": np.asarray(p["initialized"]).astype(np.int64)
            .reshape(())}


def _vit(sd, prefix, p):
    if "linear_encoding" in p:
        _put(sd, f"{prefix}.linear_encoding", _linear(p["linear_encoding"]))
        _put(sd, f"{prefix}.mlp_head.0", _linear(p["mlp_head"]["l1"]))
        _put(sd, f"{prefix}.mlp_head.3", _linear(p["mlp_head"]["l2"]))
    for i, layer in enumerate(p["layers"]):
        lp = f"{prefix}.encoder.layers.{i}"
        a = layer["attn"]
        sd[f"{lp}.self_attn.in_proj_weight"] = np.concatenate(
            [np.asarray(a[k]).T for k in ("wq", "wk", "wv")], axis=0)
        sd[f"{lp}.self_attn.out_proj.weight"] = np.asarray(a["wo"]).T
        _put(sd, f"{lp}.linear1", _linear(layer["linear1"]))
        _put(sd, f"{lp}.linear2", _linear(layer["linear2"]))
        for norm in ("norm1", "norm2"):
            if norm in layer:
                sd[f"{lp}.{norm}.weight"] = np.asarray(layer[norm]["g"])
                sd[f"{lp}.{norm}.bias"] = np.asarray(layer[norm]["b"])
    if "pos" in p:
        sd[f"{prefix}.position_encoding.pe.weight"] = np.asarray(p["pos"])


def _put(sd, prefix, tensors):
    for k, v in tensors.items():
        sd[f"{prefix}.{k}"] = v


def state_dict_from_jax(params, spec: GenSpec) -> dict:
    """JAX param tree of `spec` -> {key: torch.Tensor} for Generator(spec)."""
    check_ported(spec)
    sd: dict = {}
    _put(sd, "head.0.0", _conv(params["head"]["conv"]))
    _put(sd, "head.0.1.body.0", _conv(params["head"]["res"]["c1"]))
    _put(sd, "head.0.1.body.2", _conv(params["head"]["res"]["c2"]))
    _put(sd, "ds_conv_e01.0", _conv(params["ds_e01"]["conv"]))
    for lvl in (1, 2, 3):
        if lvl > 1:
            _put(sd, f"ds_conv_e0{lvl}.0", _conv(params[f"ds_e0{lvl}"]["conv"]))
        _vit(sd, f"localvit_encoder_0{lvl}", params[f"lvit_e0{lvl}"])
        _vit(sd, f"globalvit_encoder_0{lvl}", params[f"gvit_e0{lvl}"])
        _put(sd, f"lgcat_conv_e0{lvl}.0", _conv(params[f"lgcat_e0{lvl}"]["conv"]))
        _put(sd, f"lgcat_conv_e0{lvl}.1", _an(params[f"lgcat_e0{lvl}"]["an"]))
    for b in "rsd":
        for lvl in (3, 2, 1):
            _vit(sd, f"localvit_decoder_0{lvl}{b}", params[f"lvit_d0{lvl}{b}"])
            _vit(sd, f"globalvit_decoder_0{lvl}{b}", params[f"gvit_d0{lvl}{b}"])
            key = f"lgcat_d0{lvl}{b}"
            _put(sd, f"lgcat_conv_d0{lvl}{b}.0", _conv(params[key]["conv"]))
            _put(sd, f"lgcat_conv_d0{lvl}{b}.1", _an(params[key]["an"]))
        _put(sd, f"us_conv_d03{b}.0", _convT(params[f"us_d03{b}"]["conv"]))
        for lvl in (2, 1):
            us = params[f"us_d0{lvl}{b}"]
            _put(sd, f"us_conv_d0{lvl}{b}.0", _convT(us["conv"]))
            _put(sd, f"us_conv_d0{lvl}{b}.1", _an(us["an"]))
        if b in "rs":
            for lvl in (3, 2):
                sk = params[f"sk_d0{lvl}{b}"]
                _put(sd, f"sk_conv_d0{lvl}{b}.0", _conv(sk["conv"]))
                _put(sd, f"sk_conv_d0{lvl}{b}.1", _an(sk["an"]))
    for lvl in (3, 2):
        for name, fc in params[f"cfs_d0{lvl}d"].items():
            prefix = f"cfsm2g_d0{lvl}d.0.{name}"
            sd[f"{prefix}.0.weight"] = np.asarray(fc["c1"]["w"]).transpose(3, 2, 0, 1)
            sd[f"{prefix}.2.weight"] = np.asarray(fc["c2"]["w"]).transpose(3, 2, 0, 1)
    for b, name in (("r", "tail_R"), ("s", "tail_S"), ("d", "tail_D")):
        tp = params[f"tail_{b}"]
        _put(sd, f"{name}.0.1", _conv(tp["conv1"]))
        if "an" in tp:
            _put(sd, f"{name}.0.2", _an(tp["an"]))
        _put(sd, f"{name}.0.{5 if b != 's' else 4}", _conv(tp["conv2"]))
    return _tensors(sd)


def _tensors(sd):
    return {k: torch.tensor(np.ascontiguousarray(v)) for k, v in sd.items()}


def discriminator_state_dict_from_jax(params, kind: str = "basic") -> dict:
    """JAX define_d tree -> models/discriminator.py Discriminator keys:
    NLayer convs sit at model.0, 2, 5, 8, ... (conv, norm, LeakyReLU per
    block), Pixel convs at net.0, 2, 5."""
    sd: dict = {}
    if kind == "pixel":
        for key, idx in (("c1", 0), ("c2", 2), ("c3", 5)):
            _put(sd, f"net.{idx}", _conv(params[key]))
    else:
        for i, conv in enumerate(params["layers"]):
            _put(sd, f"model.{0 if i == 0 else 3 * i - 1}", _conv(conv))
    return _tensors(sd)


def deform_pack_state_dict_from_jax(params) -> dict:
    """JAX modulated_deform_conv_pack_init tree {w HWIO, b, conv_offset_mask:
    {w, b}} -> ops/deform_conv.py ModulatedDeformConvPack keys."""
    sd = _conv(params)
    _put(sd, "conv_offset_mask", _conv(params["conv_offset_mask"]))
    return _tensors(sd)


def vgg_state_dict_from_jax(params) -> dict:
    """JAX vgg19_init tree {conv{k}_{i}: {w HWIO, b}} -> losses/vgg.py VGG19
    keys (OIHW)."""
    sd: dict = {}
    for name, conv in params.items():
        _put(sd, name, _conv(conv))
    return {k: t.float() for k, t in _tensors(sd).items()}
