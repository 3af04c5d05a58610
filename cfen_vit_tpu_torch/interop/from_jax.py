"""Weight bridge: JAX param trees (numpy arrays) -> the port's state_dicts
(counterpart of cfen_vit_tpu/interop/torch_export.py): the generator, the
PatchGAN discriminators, the VGG19 tower, the DCNv2 Pack and every
network of the EPDN family (models/epdn.py).

Pure numpy with the exporter's transposes (torch_export.py _conv, _convT,
_linear, _an), so it never imports the JAX package.  It writes exactly the
tensors the port's modules own: the exporter's key set minus the dead
tensors it synthesises for the reference (interop/torch_import.py lists
them).  Covers every `--model_G` spec, with the reference names of each
family (models/generator.py's `*_name` functions, JAX
interop/torch_import.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import generator as G
from ..models.generator import GenSpec


def _conv(p):
    out = {"weight": np.asarray(p["w"]).transpose(3, 2, 0, 1)}
    if "b" in p:
        out["bias"] = np.asarray(p["b"])
    return out


def _convT(p):
    # a copy: a flipped 1x1 keeps negative strides that
    # np.ascontiguousarray lets through and torch.tensor refuses
    return {"weight": np.asarray(p["w"]).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1].copy(),
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
    for key in ("conv_shrink", "conv_extend"):
        if key in p:
            _put(sd, f"{prefix}.{key}.0", _conv(p[key]["conv"]))
            _put(sd, f"{prefix}.{key}.1", _an(p[key]["an"]))
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


def _conv_an(sd, prefix, p, conv=_conv):
    """{conv, an?} -> `prefix.0` (+ `prefix.1`)."""
    _put(sd, f"{prefix}.0", conv(p["conv"]))
    if "an" in p:
        _put(sd, f"{prefix}.1", _an(p["an"]))


def _level(sd, params, spec, encoder, lvl, jsfx, sfx):
    """One level's blocks; `jsfx` the JAX key suffix, `sfx` the port's."""
    tag = "e" if encoder else "d"
    cnn, lname, gname, cname = G.level_names(spec, encoder, lvl, sfx)
    if spec.cnn:
        for i, blk in enumerate(params[f"cnn_{tag}0{lvl}{jsfx}"]):
            for conv, an, slot in (("c1", "an1", 1), ("c2", "an2", 5)):
                _put(sd, f"{cnn}.{i}.conv_block.{slot}", _conv(blk[conv]))
                _put(sd, f"{cnn}.{i}.conv_block.{slot + 1}", _an(blk[an]))
        return
    for jkey, name in (("lvit", lname), ("gvit", gname)):
        if f"{jkey}_{tag}0{lvl}{jsfx}" in params:
            _vit(sd, name, params[f"{jkey}_{tag}0{lvl}{jsfx}"])
    if f"lgcat_{tag}0{lvl}{jsfx}" in params:
        _conv_an(sd, cname, params[f"lgcat_{tag}0{lvl}{jsfx}"])


def state_dict_from_jax(params, spec: GenSpec) -> dict:
    """JAX param tree of `spec` -> {key: torch.Tensor} for Generator(spec)."""
    sd: dict = {}
    _put(sd, "head.0.0", _conv(params["head"]["conv"]))
    _put(sd, "head.0.1.body.0", _conv(params["head"]["res"]["c1"]))
    _put(sd, "head.0.1.body.2", _conv(params["head"]["res"]["c2"]))
    if spec.half_res_trunk:
        _put(sd, "ds_conv_e01.0", _conv(params["ds_e01"]["conv"]))
    # JAX keys dec_ipt's encoders by branch letter (r, s), the port by the
    # reference suffix ("", s)
    jencs = list(spec.branches) if spec.separate_encoders else [""]
    for je in jencs:
        e = G.enc_suffix(spec, je) if je else ""
        for lvl in (1, 2, 3):
            if lvl > 1:
                _conv_an(sd, f"ds_conv_e0{lvl}{e}", params[f"ds_e0{lvl}{je}"])
            _level(sd, params, spec, True, lvl, je, e)
    for b in spec.branches:
        for lvl in (3, 2, 1):
            _level(sd, params, spec, False, lvl, b, b)
        _put(sd, f"{G.us_name(spec, 3, b)}.0", _convT(params[f"us_d03{b}"]["conv"]))
        _conv_an(sd, G.us_name(spec, 2, b), params[f"us_d02{b}"], _convT)
        if spec.half_res_trunk:
            _conv_an(sd, f"us_conv_d01{b}", params[f"us_d01{b}"], _convT)
        if G.has_sk(spec, b):
            conv = _convT if (spec.sk_conv_transposed or (
                b == "d" and spec.d_skip == "cat_partner")) else _conv
            for lvl in (3, 2):
                _conv_an(sd, f"sk_conv_d0{lvl}{b}", params[f"sk_d0{lvl}{b}"],
                         conv)
    if spec.d_skip == "cfs":
        for lvl in (3, 2):
            for name, fc in params[f"cfs_d0{lvl}d"].items():
                prefix = f"cfsm2g_d0{lvl}d.0.{name}"
                sd[f"{prefix}.0.weight"] = np.asarray(fc["c1"]["w"]).transpose(3, 2, 0, 1)
                sd[f"{prefix}.2.weight"] = np.asarray(fc["c2"]["w"]).transpose(3, 2, 0, 1)
    for b in G.tail_branches(spec):
        name, tp = G.tail_name(spec, b), params[f"tail_{b}"]
        _put(sd, f"{name}.0.1", _conv(tp["conv1"]))
        if "an" in tp:
            _put(sd, f"{name}.0.2", _an(tp["an"]))
        slot = 4 if G.tail_norm(spec, b) is None else 5
        _put(sd, f"{name}.0.{slot}", _conv(tp["conv2"]))
    if spec.xdh:
        for name, conv in params["sp"].items():
            _put(sd, f"sp.{name}.0" if name == "refine3" else f"sp.{name}",
                 _conv(conv))
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
    return _tensors(sd)


# -- the EPDN family (models/epdn.py); the JAX package has no .pth importer
# for it, so these keys are the port's module names


def _resblock(sd, prefix, p):
    _put(sd, f"{prefix}.conv_block.1", _conv(p["c1"]))
    _put(sd, f"{prefix}.conv_block.5", _conv(p["c2"]))


def _global_trunk(sd, prefix, p):
    """GlobalGenerator's `model` slots, the c7s1 tail left to the caller."""
    nd, nb = len(p["down"]), len(p["blocks"])
    _put(sd, f"{prefix}.1", _conv(p["head"]))
    for i, conv in enumerate(p["down"]):
        _put(sd, f"{prefix}.{4 + 3 * i}", _conv(conv))
    for j, blk in enumerate(p["blocks"]):
        _resblock(sd, f"{prefix}.{4 + 3 * nd + j}", blk)
    for i, conv in enumerate(p["up"]):
        _put(sd, f"{prefix}.{4 + 3 * nd + nb + 3 * i}", _convT(conv))
    return 4 + 3 * nd + nb + 3 * len(p["up"])


def global_generator_state_dict_from_jax(params) -> dict:
    sd: dict = {}
    tail = _global_trunk(sd, "model", params)
    _put(sd, f"model.{tail + 1}", _conv(params["tail"]))
    return _tensors(sd)


def _dehaze(sd, prefix, p):
    for name, conv in p.items():
        _put(sd, f"{prefix}.{name}", _conv(conv))


def dehaze_state_dict_from_jax(params) -> dict:
    sd: dict = {}
    _dehaze(sd, "", params)
    return _tensors({k[1:]: v for k, v in sd.items()})


def local_enhancer_state_dict_from_jax(params) -> dict:
    """The JAX tree's global tail is unused (the trunk runs without it)
    and has no slot here."""
    sd: dict = {}
    _global_trunk(sd, "model", params["global"])
    _put(sd, "model1_1.1", _conv(params["down_head"]))
    _put(sd, "model1_1.4", _conv(params["down_conv"]))
    nbl = len(params["local_blocks"])
    for j, blk in enumerate(params["local_blocks"]):
        _resblock(sd, f"model1_2.{j}", blk)
    _put(sd, f"model1_2.{nbl}", _convT(params["up_conv"]))
    _put(sd, f"model1_2.{nbl + 4}", _conv(params["tail"]))
    _dehaze(sd, "dehaze", params["dehaze"])
    _dehaze(sd, "dehaze2", params["dehaze2"])
    return _tensors(sd)


def encoder_state_dict_from_jax(params) -> dict:
    sd: dict = {}
    nd = len(params["down"])
    _put(sd, "model.1", _conv(params["head"]))
    for i, conv in enumerate(params["down"]):
        _put(sd, f"model.{4 + 3 * i}", _conv(conv))
    for i, conv in enumerate(params["up"]):
        _put(sd, f"model.{4 + 3 * nd + 3 * i}", _convT(conv))
    _put(sd, f"model.{4 + 6 * nd + 1}", _conv(params["tail"]))
    return _tensors(sd)


def _hw_sff(sd, prefix, p):
    sd[f"{prefix}.conv_squeeze.0.weight"] = np.asarray(p["squeeze"]["w"]).T[
        :, :, None, None]
    sd[f"{prefix}.conv_squeeze.1.weight"] = np.asarray(p["prelu_a"])
    for i, fc in enumerate(p["fcs"]):
        sd[f"{prefix}.fcs_f{i}.weight"] = np.asarray(fc["w"]).T[:, :, None, None]
    _put(sd, f"{prefix}.conv_smooth.conv", _conv(p["smooth"]))


def hw_sff_state_dict_from_jax(params) -> dict:
    sd: dict = {}
    _hw_sff(sd, "", params)
    return _tensors({k[1:]: v for k, v in sd.items()})


def _omni_extractor(sd, prefix, p):
    for bank in (0, 1):
        for i, conv in enumerate(p[f"bank{bank}"]):
            _put(sd, f"{prefix}.extractor_{bank}_{i}.conv", _conv(conv))
        _hw_sff(sd, f"{prefix}.rwsff_{bank}", p[f"sff{bank}"])


def omni_feature_extractor_state_dict_from_jax(params) -> dict:
    sd: dict = {}
    _omni_extractor(sd, "", params)
    return _tensors({k[1:]: v for k, v in sd.items()})


def omni_local_enhancer_state_dict_from_jax(params) -> dict:
    sd: dict = {}
    for ext in ("ext_coarse", "ext_fine"):
        _omni_extractor(sd, ext, params[ext])
    for trunk in ("coarse", "fine"):
        t = params[trunk]
        for part, conv in (("down", _conv), ("up", _convT)):
            for i, lvl in enumerate(t[part]):
                _put(sd, f"{trunk}.{part}.{i}.conv", conv(lvl["conv"]))
                _resblock(sd, f"{trunk}.{part}.{i}.block", lvl["block"])
        for j, blk in enumerate(t["blocks"]):
            _resblock(sd, f"{trunk}.blocks.{j}", blk)
    _put(sd, "final_up", _convT(params["final_up"]))
    for j, blk in enumerate(params["final_blocks"]):
        _resblock(sd, f"final_blocks.{j}", blk)
    _put(sd, "final_c5", _conv(params["final_c5"]))
    _put(sd, "final_c7", _conv(params["final_c7"]))
    _dehaze(sd, "dehaze", params["dehaze"])
    _dehaze(sd, "dehaze2", params["dehaze2"])
    return _tensors(sd)


def multiscale_disc_state_dict_from_jax(params) -> dict:
    """{scales: [{convs}]} -> layer{i} Sequentials: convs at 0, 2, 5, 8, ..."""
    sd: dict = {}
    for s, scale in enumerate(params["scales"]):
        for i, conv in enumerate(scale["convs"]):
            _put(sd, f"layer{s}.{0 if i == 0 else 3 * i - 1}", _conv(conv))
    return _tensors(sd)
