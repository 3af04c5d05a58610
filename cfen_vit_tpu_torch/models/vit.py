"""Local/Global ViT blocks and the 1-layer pre-norm encoder (counterpart of
cfen_vit_tpu/models/vit.py).

Tokens are batch-first [N, S, E]; maps are NCHW.  Parameter names are the
reference's (LViT/GViT, TransformerEncoder(Layer), nn.MultiheadAttention
with bias=False), so `localvit_encoder_01.encoder.layers.0.self_attn.
in_proj_weight` and friends load from a reference checkpoint as they are.
The reference's never-called TransformerDecoder and query_embed are not
built (interop/torch_import.py drops their tensors).  The v5 variant
shrinks the channels a block tokenises by `shrink` with a 1x1 conv +
ActNorm + ReLU (`conv_shrink`) and extends them back after it
(`conv_extend`), JAX vit_shrink_apply.

The attention core goes through ops/cuda_attn.py (K1); the projections,
the MLPs and the norms stay F.linear / nn.LayerNorm, as the JAX package
leaves them to XLA.  With CFEN_PALLAS_VIT=1 a block that
ops/cuda_vit.py `supported` admits runs its whole token pipeline through
K2 instead (JAX vit_tokens_apply's dispatch).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import cuda_attn, cuda_vit
from ..ops.nn import ActNorm2d
from ..ops.patch import fold_tokens, unfold_tokens
from ..ops.resize import avg_pool2, upsample_bilinear2


@dataclass(frozen=True)
class ViTSpec:
    img_dim: int          # spatial size the token grid covers
    patch_dim: int
    num_channels: int
    embedding_dim: int
    num_heads: int
    num_layers: int
    hidden_dim: int
    no_norm: bool = False
    no_mlp: bool = False
    pos_every: bool = False
    no_pos: bool = False
    global_pools: int = 0  # GViT: #avg-pool-2x before / bilinear-2x after
    shrink: int = 1        # v5 variant: channel shrink factor inside the ViT

    @property
    def seq_length(self) -> int:
        return (self.img_dim // self.patch_dim) ** 2

    @property
    def inner_channels(self) -> int:
        """Channels tokenised (v5 shrinks them by `shrink` first)."""
        return self.num_channels // self.shrink

    @property
    def flatten_dim(self) -> int:
        return self.patch_dim * self.patch_dim * self.inner_channels


class SelfAttention(nn.Module):
    """nn.MultiheadAttention(bias=False) parameters; forward is JAX
    mha_apply: packed q/k/v projections, K1 core, out projection."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.out_proj = nn.Linear(dim, dim, bias=False)

    def forward(self, q_in, k_in, v_in):
        wq, wk, wv = self.in_proj_weight.chunk(3)
        out = cuda_attn.block_attention(F.linear(q_in, wq), F.linear(k_in, wk),
                                        F.linear(v_in, wv), self.num_heads)
        return self.out_proj(out)


class EncoderLayer(nn.Module):
    """Pre-norm TransformerEncoderLayer (JAX encoder_layer_apply)."""

    def __init__(self, dim: int, num_heads: int, hidden: int, no_norm: bool):
        super().__init__()
        self.self_attn = SelfAttention(dim, num_heads)
        self.linear1 = nn.Linear(dim, hidden)
        self.linear2 = nn.Linear(hidden, dim)
        self.norm1 = nn.Identity() if no_norm else nn.LayerNorm(dim)
        self.norm2 = nn.Identity() if no_norm else nn.LayerNorm(dim)

    def forward(self, src, pos=None):
        src2 = self.norm1(src)
        qk = src2 if pos is None else src2 + pos
        src = src + self.self_attn(qk, qk, src2)
        src2 = self.linear2(F.relu(self.linear1(self.norm2(src))))
        return src + src2


class TransformerEncoder(nn.Module):
    def __init__(self, spec: ViTSpec):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(spec.embedding_dim, spec.num_heads, spec.hidden_dim,
                         spec.no_norm) for _ in range(spec.num_layers))


class LearnedPositionalEncoding(nn.Module):
    def __init__(self, seq_length: int, dim: int):
        super().__init__()
        self.pe = nn.Embedding(seq_length, dim)


class ViT(nn.Module):
    """One LViT or GViT block (JAX vit_init / vit_tokens_apply / vit_apply).

    `tokens` is the token pipeline on [N, S, flatten]; `forward` applies the
    block to an NCHW map, pooling before and upsampling after for a GViT.
    The LViT's tiling is the generator's (models/generator.py), which also
    applies an LViT's shrink and extend on the whole map (`bottleneck`):
    they are pointwise, so they commute with the tiling."""

    def __init__(self, spec: ViTSpec):
        super().__init__()
        self.spec = spec
        e = spec.embedding_dim
        if spec.shrink > 1:
            c, c_sh = spec.num_channels, spec.inner_channels
            self.conv_shrink = nn.Sequential(nn.Conv2d(c, c_sh, 1),
                                             ActNorm2d(c_sh))
            self.conv_extend = nn.Sequential(nn.Conv2d(c_sh, c, 1),
                                             ActNorm2d(c))
        if not spec.no_mlp:
            self.linear_encoding = nn.Linear(spec.flatten_dim, e)
            # reference slots: Linear, ReLU, Dropout(0), Linear
            self.mlp_head = nn.Sequential(
                nn.Linear(e, spec.hidden_dim), nn.ReLU(), nn.Identity(),
                nn.Linear(spec.hidden_dim, spec.flatten_dim))
        self.encoder = TransformerEncoder(spec)
        if not spec.no_pos:
            self.position_encoding = LearnedPositionalEncoding(
                spec.seq_length, e)

    def fused_weights(self) -> tuple:
        """The block's parameters in cuda_vit.FUSED_WEIGHTS order."""
        layer = self.encoder.layers[0]
        attn = layer.self_attn
        return (self.linear_encoding.weight, self.linear_encoding.bias,
                self.position_encoding.pe.weight, layer.norm1.weight,
                layer.norm1.bias, attn.in_proj_weight, attn.out_proj.weight,
                layer.norm2.weight, layer.norm2.bias, layer.linear1.weight,
                layer.linear1.bias, layer.linear2.weight, layer.linear2.bias,
                self.mlp_head[0].weight, self.mlp_head[0].bias,
                self.mlp_head[3].weight, self.mlp_head[3].bias)

    def tokens(self, t: torch.Tensor) -> torch.Tensor:
        spec = self.spec
        if cuda_vit.use_fused_vit() and cuda_vit.supported(spec):
            return cuda_vit.fused_tokens(t, self.fused_weights(),
                                         spec.num_heads)
        if not spec.no_mlp:
            t = self.linear_encoding(t) + t
        pos = None if spec.no_pos else self.position_encoding.pe.weight
        if pos is not None and not spec.pos_every:
            t = t + pos
        for layer in self.encoder.layers:
            t = layer(t, pos if spec.pos_every else None)
        if not spec.no_mlp:
            t = self.mlp_head(t) + t
        return t

    def bottleneck(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """v5's 1x1 conv + ActNorm + ReLU, `name` conv_shrink or
        conv_extend; the identity for a block without the shrink."""
        if self.spec.shrink == 1:
            return x
        return F.relu(getattr(self, name)(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for _ in range(self.spec.global_pools):
            x = avg_pool2(x)
        x = self.bottleneck("conv_shrink", x)
        h, w = x.shape[2:]
        t = self.tokens(unfold_tokens(x, self.spec.patch_dim))
        x = self.bottleneck("conv_extend",
                            fold_tokens(t, self.spec.patch_dim, h, w))
        for _ in range(self.spec.global_pools):
            x = upsample_bilinear2(x)
        return x
