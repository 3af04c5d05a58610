"""Exporter: the port's generator -> a reference-format state_dict
(counterpart of cfen_vit_tpu/interop/torch_export.py).

The reference loads strictly (base_model.py:131), so the exported dict
holds every tensor its modules own, the dead ones too, which the port
does not build (interop/torch_import.py drops them on load).  They are
synthesised as the JAX exporter does:

  * in every LViT/GViT block, the never-called TransformerDecoder as
    zeros (ones for its LayerNorm weights), `query_embed` as zeros where
    the block has an MLP, and the `position_ids` buffer as arange where
    it has positions;
  * the MeanShift `sub_mean`/`add_mean` 1x1 convs: identity weights and
    -/+ 255 x the RGB mean as biases (ref common.py:16-26).

The live tensors are the port's own state_dict: its modules carry the
reference's names (models/generator.py).  Covers the families the JAX
exporter covers (the 3-branch hlgvit family); it raises for the others,
as the JAX exporter does.

    sd = export_generator_state_dict(net)         # {key: torch.Tensor}
    save_reference_pth(net, "5_net_G.pth")
"""

from __future__ import annotations

import torch

from ..models.generator import Generator
from ..models.vit import ViT

RGB_MEAN = (0.4488, 0.4371, 0.4040)


def _dead_decoder(sd, prefix: str, e: int, hidden: int) -> None:
    """TransformerDecoderLayer parameters the forward never touches
    (ref v3:1409-1447)."""
    lp = f"{prefix}.decoder.layers.0"
    for attn in ("self_attn", "multihead_attn"):
        sd[f"{lp}.{attn}.in_proj_weight"] = torch.zeros(3 * e, e)
        sd[f"{lp}.{attn}.out_proj.weight"] = torch.zeros(e, e)
    sd[f"{lp}.linear1.weight"] = torch.zeros(hidden, e)
    sd[f"{lp}.linear1.bias"] = torch.zeros(hidden)
    sd[f"{lp}.linear2.weight"] = torch.zeros(e, hidden)
    sd[f"{lp}.linear2.bias"] = torch.zeros(e)
    for norm in ("norm1", "norm2", "norm3"):
        sd[f"{lp}.{norm}.weight"] = torch.ones(e)
        sd[f"{lp}.{norm}.bias"] = torch.zeros(e)


def _meanshift(sd, prefix: str, sign: int, rgb_range: int = 255) -> None:
    sd[f"{prefix}.weight"] = torch.eye(3).reshape(3, 3, 1, 1)
    sd[f"{prefix}.bias"] = sign * rgb_range * torch.tensor(RGB_MEAN)


def dead_tensors(net: Generator) -> dict:
    """What a reference checkpoint of `net`'s spec stores and never uses."""
    sd: dict = {}
    _meanshift(sd, "sub_mean", -1)
    _meanshift(sd, "add_mean", 1)
    for prefix, m in net.named_modules():
        if not isinstance(m, ViT):
            continue
        vs = m.spec
        _dead_decoder(sd, prefix, vs.embedding_dim, vs.hidden_dim)
        if not vs.no_mlp:
            sd[f"{prefix}.query_embed.weight"] = torch.zeros(
                1, vs.embedding_dim * vs.seq_length)
        if not vs.no_pos:
            sd[f"{prefix}.position_encoding.position_ids"] = torch.arange(
                vs.seq_length, dtype=torch.int64)[None]
    return sd


def export_generator_state_dict(net: Generator) -> dict:
    """The port's generator -> {key: float32 CPU tensor} that the reference
    generator of its spec loads with strict=True."""
    spec = net.spec
    if spec.cnn or spec.ipt_style or spec.xdh or spec.branches != "rsd":
        raise NotImplementedError(
            "export covers the 3-branch hlgvit family, as the JAX exporter")
    sd = {k: v.detach().to("cpu", torch.float32 if v.is_floating_point()
                           else v.dtype).clone()
          for k, v in net.state_dict().items()}
    sd.update(dead_tensors(net))
    return sd


def save_reference_pth(net: Generator, path: str) -> str:
    torch.save(export_generator_state_dict(net), path)
    return path
