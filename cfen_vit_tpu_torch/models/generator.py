"""HLG-ViT IID generator, plain path of the v3 variant (counterpart of
cfen_vit_tpu/models/generator.py).

Canonical v3 at a 512x512 input (n_feats 24, patch_size 32, patch_dim 2,
loadSize 256):

  stem   conv5x5 3->12 + ResBlock (K4, ops/cuda_stem.py), stride-2 conv
         12->24 + InstanceNorm + ReLU -> trunk at 256x256x24
  enc    3 levels: batched local ViT over 32px tiles + global ViT on the
         4x-pooled map, fused by 1x1 conv + ActNorm + ReLU, plus residual;
         stride-2 conv + InstanceNorm + ReLU between levels
  dec    R, S, D decoders; R/S fuse each upsample with the encoder skip
         (sk_conv), D fuses its own upsample with R's and S's through the
         CFSM2G channel attention (cfs)
  tails  ConvTranspose back to full res + ActNorm + ReLU, conv3x3
         (+ActNorm) + ReLU, reflect-pad 3 + conv7x7 + tanh (K3,
         ops/cuda_tail.py); S has 1 channel and no tail norm

Module names follow the reference state_dict.  The JAX package's TPU-only
phase-space forms (ops/phase_space.py) are not ported: they re-express this
same plain path for the TPU's lane layout.

With branches="d" (test --out_all) the forward runs only what fake_A needs:
the R/S decoders stop after their level-2 upsample, whose output D's CFS
reads, and the R/S level-1 blocks and tails are skipped.  (JAX leaves that
pruning to XLA's dead-code elimination; eager PyTorch has to do it.)

For training, `remat` checkpoints the regions the JAX generator_apply
checkpoints (torch.utils.checkpoint, non-reentrant): "level" every
encoder and decoder level, "branch" every encoder level and each decoder
branch as one region.  Stem and tails are never checkpointed.  A forward
that still has uninitialised ActNorms (the data-dependent init pass) runs
without remat, as in JAX.  The JAX modes "level_dots" and "vit" were
rejected by measurement there and are not ported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops import cuda_stem, cuda_tail
from ..ops.nn import ActNorm2d, conv_transpose_up2, instance_norm
from ..ops.tiles import join_tiles, split_tiles
from ..ops.patch import fold_tokens, unfold_tokens
from .vit import ViT, ViTSpec


@dataclass(frozen=True)
class GenSpec:
    """The JAX package's GenSpec, field for field (see its docstrings).
    Only the v3 structure is built here; see `check_ported`."""
    name: str = "iid_hlgvit_crs_gd4_cfs_v3"
    n_feats: int = 24
    n_colors: int = 3
    patch_size: int = 32          # LViT tile side
    patch_dim: int = 2
    num_heads: int = 4
    num_layers: int = 1
    hidden_dim_ratio: int = 4
    load_size: int = 256          # trunk feature size (== reference loadSize)
    half_res_trunk: bool = True
    use_local: bool = True
    use_global: bool = True
    fusion: str = "cat"
    d_skip: str = "cfs"
    branches: str = "rsd"
    shrink: int = 1
    global_pools: int = 2
    shared_tails: bool = False
    lgcat_norm: str = "actnorm"
    ds_norm: str = "instance"
    cnn: bool = False
    xdh: bool = False
    ipt_style: bool = False
    separate_encoders: bool = False
    s_dec_from_r_enc: bool = False
    s_dec1_ru_zero: bool = False
    tail_norm: str = "actnorm"
    s_tail_norm: bool = False
    sk_conv_transposed: bool = False
    d02_us_from_s: bool = False
    no_norm: bool = False
    no_mlp: bool = False
    pos_every: bool = False
    no_pos: bool = False

    def level_channels(self, lvl: int) -> int:          # lvl in {1,2,3}
        return self.n_feats * (1 << (lvl - 1))

    def level_size(self, lvl: int) -> int:
        return self.load_size >> (lvl - 1)

    def stem_channels(self) -> int:
        return self.n_feats // 2 if self.half_res_trunk else self.n_feats

    def lvit_spec(self, lvl: int) -> ViTSpec:
        c = self.level_channels(lvl)
        e = c * self.patch_dim ** 2
        return ViTSpec(
            img_dim=self.patch_size, patch_dim=self.patch_dim,
            num_channels=c, embedding_dim=e // self.shrink,
            num_heads=self.num_heads * (1 << (lvl - 1)),
            num_layers=self.num_layers,
            hidden_dim=e * self.hidden_dim_ratio // self.shrink,
            no_norm=self.no_norm, no_mlp=self.no_mlp,
            pos_every=self.pos_every, no_pos=self.no_pos,
            shrink=self.shrink)

    def gvit_spec(self, lvl: int, encoder: bool) -> ViTSpec:
        c = self.level_channels(lvl)
        pd = self.patch_dim * 2
        e = c * pd * pd
        hidden = e * self.hidden_dim_ratio
        if encoder and lvl == 2:
            # reference quirk: globalvit_encoder_02 computes its hidden dim
            # with patch_dim instead of 2*patch_dim (ref v3:200); without it
            # a reference checkpoint does not load
            hidden = c * self.patch_dim ** 2 * self.hidden_dim_ratio
        return ViTSpec(
            img_dim=self.level_size(lvl) >> self.global_pools,
            patch_dim=pd, num_channels=c, embedding_dim=e,
            num_heads=self.num_heads * (1 << (lvl - 1)),
            num_layers=self.num_layers, hidden_dim=hidden,
            no_norm=self.no_norm, no_mlp=self.no_mlp,
            pos_every=self.pos_every, no_pos=self.no_pos,
            global_pools=self.global_pools, shrink=1)


# geometry and transformer flags are free; every other field is a variant
# switch and must keep its v3 value
_FREE = {"name", "n_feats", "n_colors", "patch_size", "patch_dim",
         "num_heads", "num_layers", "hidden_dim_ratio", "load_size",
         "no_norm", "no_mlp", "pos_every", "no_pos"}
REMAT_MODES = ("none", "level", "branch")


def check_ported(spec: GenSpec) -> None:
    v3 = GenSpec()
    diff = [f.name for f in fields(GenSpec) if f.name not in _FREE
            and getattr(spec, f.name) != getattr(v3, f.name)]
    if diff:
        raise NotImplementedError(
            f"--model_G {spec.name}: only the v3 structure is ported; this "
            f"variant differs in {diff} (ROADMAP Queue A item 6)")


def _conv_an(cin: int, cout: int) -> nn.Sequential:
    """1x1 conv + ActNorm (reference `[conv, ActNorm2d]` Sequential)."""
    return nn.Sequential(nn.Conv2d(cin, cout, 1), ActNorm2d(cout))


class ResBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.body = nn.Sequential(nn.Conv2d(c, c, 3, padding=1), nn.ReLU(),
                                  nn.Conv2d(c, c, 3, padding=1))


class CFSM2G(nn.Module):
    """Channel-attention fusion of the D, R and S upsamples (JAX cfs_apply):
    four bias-free squeeze-excite stacks on the global mean and max."""

    def __init__(self, c: int):
        super().__init__()

        def fc():
            return nn.Sequential(nn.Conv2d(c, c // 4, 1, bias=False),
                                 nn.ReLU(),
                                 nn.Conv2d(c // 4, c, 1, bias=False))
        self.fc_avg_cf1, self.fc_avg_cf2 = fc(), fc()
        self.fc_max_cf1, self.fc_max_cf2 = fc(), fc()

    def forward(self, d, r, s):
        comb = d + r + s
        gavg = comb.mean(dim=(2, 3), keepdim=True)
        gmax = comb.amax(dim=(2, 3), keepdim=True)
        sig1 = torch.sigmoid(self.fc_avg_cf1(gavg) + self.fc_max_cf1(gmax))
        sig2 = torch.sigmoid(self.fc_avg_cf2(gavg) + self.fc_max_cf2(gmax))
        return d + r * sig1 + s * sig2


def _tail(c: int, out_c: int, norm: bool) -> nn.Sequential:
    """Reference tail slots: [0] upsampler (a no-op at v3), conv3x3,
    ActNorm (R/D only), ReLU, ReflectionPad(3), conv7x7, Tanh."""
    slots = [nn.Identity(), nn.Conv2d(c, c, 3, padding=1)]
    slots += [ActNorm2d(c)] if norm else []
    slots += [nn.ReLU(), nn.ReflectionPad2d(3), nn.Conv2d(c, out_c, 7),
              nn.Tanh()]
    return nn.Sequential(nn.Sequential(*slots))


class Generator(nn.Module):
    """x [B,3,H,W] in [-1,1] -> {branch: [B,out_c,H,W]} in [-1,1]."""

    def __init__(self, spec: GenSpec):
        super().__init__()
        check_ported(spec)
        self.spec = spec
        nf, c0 = spec.n_feats, spec.stem_channels()
        self.head = nn.Sequential(nn.Sequential(
            nn.Conv2d(spec.n_colors, c0, 5, padding=2), ResBlock(c0)))
        self.ds_conv_e01 = nn.Sequential(nn.Conv2d(c0, nf, 3, 2, 1))
        for lvl in (1, 2, 3):
            c = spec.level_channels(lvl)
            if lvl > 1:
                self.add_module(f"ds_conv_e0{lvl}",
                                nn.Sequential(nn.Conv2d(c // 2, c, 3, 2, 1)))
            self._add_level("encoder", "e", lvl, "", encoder=True)
        for b in "rsd":
            for lvl in (3, 2, 1):
                self._add_level("decoder", "d", lvl, b, encoder=False)
            self.add_module(f"us_conv_d03{b}",
                            nn.Sequential(conv_transpose_up2(4 * nf, 2 * nf)))
            self.add_module(f"us_conv_d02{b}", nn.Sequential(
                conv_transpose_up2(2 * nf, nf), ActNorm2d(nf)))
            self.add_module(f"us_conv_d01{b}", nn.Sequential(
                conv_transpose_up2(nf, c0), ActNorm2d(c0)))
            if b in "rs":
                self.add_module(f"sk_conv_d03{b}", _conv_an(4 * nf, 2 * nf))
                self.add_module(f"sk_conv_d02{b}", _conv_an(2 * nf, nf))
        self.cfsm2g_d03d = nn.Sequential(CFSM2G(2 * nf))
        self.cfsm2g_d02d = nn.Sequential(CFSM2G(nf))
        self.tail_R = _tail(c0, spec.n_colors, norm=True)
        self.tail_S = _tail(c0, 1, norm=False)
        self.tail_D = _tail(c0, spec.n_colors, norm=True)

    def _add_level(self, role, tag, lvl, b, encoder):
        c = self.spec.level_channels(lvl)
        sfx = f"0{lvl}{b}"
        self.add_module(f"localvit_{role}_{sfx}", ViT(self.spec.lvit_spec(lvl)))
        self.add_module(f"globalvit_{role}_{sfx}",
                        ViT(self.spec.gvit_spec(lvl, encoder)))
        self.add_module(f"lgcat_conv_{tag}{sfx}", _conv_an(2 * c, c))

    def _level(self, x, role, tag, lvl, b=""):
        """JAX _level: local + global ViT, cat, 1x1 conv + ActNorm + ReLU,
        plus the level's input."""
        sfx = f"0{lvl}{b}"
        lvit = getattr(self, f"localvit_{role}_{sfx}")
        gvit = getattr(self, f"globalvit_{role}_{sfx}")
        lgcat = getattr(self, f"lgcat_conv_{tag}{sfx}")
        return F.relu(lgcat(torch.cat([self._local_vit(lvit, x), gvit(x)],
                                      dim=1))) + x

    def _local_vit(self, lvit: ViT, x):
        """JAX _local_vit: the shared-weight LViT on every tile, batched."""
        ps, pd = self.spec.patch_size, lvit.spec.patch_dim
        b, _, h, w = x.shape
        t = lvit.tokens(unfold_tokens(split_tiles(x, ps), pd))
        return join_tiles(fold_tokens(t, pd, ps, ps), b, h, w)

    def _upsample(self, x, lvl, b):
        """ConvTranspose2d(k4, s2, p1), then InstanceNorm (level 3) or the
        Sequential's ActNorm (level 2), then ReLU."""
        u = getattr(self, f"us_conv_d0{lvl}{b}")(x)
        return F.relu(instance_norm(u) if lvl == 3 else u)

    def _tail_out(self, tail: nn.Sequential, t):
        """conv3x3 (+ActNorm) + ReLU, then the K3 epilogue."""
        slots = tail[0]
        t2 = slots[1](t)
        if isinstance(slots[2], ActNorm2d):
            t2 = slots[2](t2)
        conv7 = slots[-2]
        return cuda_tail.tail_epilogue(F.relu(t2), conv7.weight, conv7.bias)

    def actnorms_ready(self) -> bool:
        return all(m.ready() for m in self.modules()
                   if isinstance(m, ActNorm2d))

    def _decode_branch(self, b, enc, us, full, level):
        """Levels 3, 2 (and 1 if `full`) of one decoder branch; `us` holds
        the R/S upsamples D's CFS reads.  Returns (level-1 output or None,
        {3: upsample, 2: upsample})."""
        cur, us_b = enc[3], {}
        for lvl in (3, 2):
            cur = level(cur, "decoder", "d", lvl, b)
            u = us_b[lvl] = self._upsample(cur, lvl, b)
            if b == "d":
                cfs = getattr(self, f"cfsm2g_d0{lvl}d")[0]
                cur = cfs(u, us["r", lvl], us["s", lvl])
            elif full or lvl == 3:
                sk = getattr(self, f"sk_conv_d0{lvl}{b}")
                cur = F.relu(sk(torch.cat([u, enc[lvl - 1]], dim=1)))
        d1 = level(cur, "decoder", "d", 1, b) if full else None
        return d1, us_b

    def forward(self, x: torch.Tensor, branches: str = "rsd",
                remat: str = "none"):
        if branches not in ("rsd", "d"):
            raise ValueError(f"branches must be 'rsd' or 'd', got {branches!r}")
        if remat not in REMAT_MODES:
            raise NotImplementedError(
                f"remat mode {remat!r}: the port has {REMAT_MODES} (the JAX "
                "modes level_dots and vit were rejected by measurement)")
        if remat != "none" and not self.actnorms_ready():
            remat = "none"      # the init pass sees real statistics

        def ckpt(fn, *args):
            return checkpoint(fn, *args, use_reentrant=False)

        level = self._level if remat == "none" else (
            lambda *args: ckpt(self._level, *args))
        conv5, res = self.head[0][0], self.head[0][1].body
        xf = cuda_stem.fused_stem(x.contiguous(), conv5.weight, conv5.bias,
                                  res[0].weight, res[0].bias, res[2].weight,
                                  res[2].bias)
        xf = F.relu(instance_norm(self.ds_conv_e01(xf)))

        enc, cur = {}, xf
        for lvl in (1, 2, 3):
            if lvl > 1:
                cur = F.relu(instance_norm(
                    getattr(self, f"ds_conv_e0{lvl}")(cur)))
            cur = enc[lvl] = level(cur, "encoder", "e", lvl)

        us, d1 = {}, {}
        for b in "rsd":
            full = b in branches
            if remat == "branch":
                out_b, us_b = ckpt(self._decode_branch, b, enc, us, full,
                                   self._level)
            else:
                out_b, us_b = self._decode_branch(b, enc, us, full, level)
            us.update({(b, lvl): u for lvl, u in us_b.items()})
            if full:
                d1[b] = out_b

        out = {}
        for b in d1:
            t = getattr(self, f"us_conv_d01{b}")(d1[b] + xf)
            out[b] = self._tail_out(getattr(self, f"tail_{b.upper()}"),
                                    F.relu(t))
        return out


@torch.no_grad()
def init_weights(net: Generator, gen: torch.Generator) -> Generator:
    """Random weights from `gen`, with the JAX generator_init distributions:
    kaiming-normal (fan_in) convs and linears, zero biases, in_proj
    U(+-1/sqrt(E)), N(0,1) positions, unit LayerNorms.  ActNorms stay
    uninitialised until their first forward."""
    for m in net.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            # torch counts fan_in as weight.size(1) * receptive field; for
            # ConvTranspose2d that is out-channels * k * k, as in JAX
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=gen)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0, generator=gen)
    for m in net.modules():
        if isinstance(m, ViT):
            for layer in m.encoder.layers:
                w = layer.self_attn.in_proj_weight
                bound = 1.0 / math.sqrt(w.shape[1])
                w.uniform_(-bound, bound, generator=gen)
    return net
