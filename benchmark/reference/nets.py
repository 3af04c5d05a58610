"""Frozen plain reference of the generator and discriminator, in float32
PyTorch with no kernel: a copy of the port's plain path (the generator
of models/generator.py, models/vit.py and ops/nn.py, the discriminator
of models/discriminator.py) for the two specs the benchmark runs, taken
so that a later change to the program cannot move the yardstick.

Parameter names are the reference checkpoints' (those of the port), so
one state dict loads into both.  Maps are NCHW, tokens [N, S, E].

Departures from the port, none in the arithmetic:
  * the ActNorm data-dependent init runs when `forward(..., init=True)`
    asks for it, not on a device read of the `initialized` buffers, so
    the module also runs on the meta device for the FLOP count;
  * no remat: the reference keeps every activation;
  * the stem, the tail and the attention are their plain forms (the port's
    cuda_stem.stem_plain, cuda_tail.tail_plain, cuda_attn.attention_core);
  * float32 only: the bf16 branch of the attention softmax is gone.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


# -- primitives ---------------------------------------------------------------

def instance_norm(x, eps: float = 1e-5):
    """InstanceNorm2d(affine=False) with one-pass statistics (E[x^2] - mu^2,
    floored at 0)."""
    mu = x.mean(dim=(2, 3), keepdim=True)
    var = (x.square().mean(dim=(2, 3), keepdim=True) - mu.square()).clamp_min(0.0)
    return (x - mu) * torch.rsqrt(var + eps)


class InstanceNorm(nn.Module):
    def forward(self, x):
        return instance_norm(x)


class ActNorm2d(nn.Module):
    """y = (x + bias) * exp(weight); in an init pass bias = -mean and
    weight = -0.5 log(max(unbiased var, 0.2)) of each input it sees."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("initialized", torch.zeros((), dtype=torch.int64))
        self.init_pass = False

    def forward(self, x):
        if self.init_pass:
            with torch.no_grad():
                flat = x.transpose(0, 1).reshape(x.shape[1], -1)
                mean = flat.mean(dim=1)
                var = (flat - mean[:, None]).square().sum(dim=1) / max(
                    flat.shape[1] - 1, 1)
                self.bias.copy_(-mean)
                self.weight.copy_(-0.5 * torch.log(var.clamp_min(0.2)))
                self.initialized.fill_(1)
        return (x + self.bias[None, :, None, None]) * torch.exp(
            self.weight)[None, :, None, None]


def up2(cin, cout):
    return nn.ConvTranspose2d(cin, cout, kernel_size=4, stride=2, padding=1)


def split_tiles(x, t):
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // t, t, w // t, t).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(-1, c, t, t)


def join_tiles(x, b, h, w):
    _, c, t, _ = x.shape
    x = x.reshape(b, h // t, w // t, c, t, t).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(b, c, h, w)


def unfold_tokens(x, p):
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // p, p, w // p, p).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(n, (h // p) * (w // p), c * p * p)


def fold_tokens(x, p, h, w):
    n, _, d = x.shape
    c = d // (p * p)
    x = x.reshape(n, h // p, w // p, c, p, p).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(n, c, h, w)


def attention(q, k, v, heads: int):
    """softmax(Q K^T / sqrt(dh)) V per head on [N, S, E]."""
    n, s, e = q.shape
    dh = e // heads
    qh = (q * (1.0 / math.sqrt(dh))).reshape(n, s, heads, dh).transpose(1, 2)
    kh = k.reshape(n, s, heads, dh).transpose(1, 2)
    vh = v.reshape(n, s, heads, dh).transpose(1, 2)
    probs = torch.softmax(qh @ kh.transpose(-1, -2), dim=-1)
    return (probs @ vh).transpose(1, 2).reshape(n, s, e)


# -- ViT ------------------------------------------------------------------

@dataclass(frozen=True)
class ViTSpec:
    img_dim: int
    patch_dim: int
    num_channels: int
    embedding_dim: int
    num_heads: int
    hidden_dim: int
    global_pools: int = 0

    @property
    def seq_length(self):
        return (self.img_dim // self.patch_dim) ** 2


class SelfAttention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.num_heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.out_proj = nn.Linear(dim, dim, bias=False)

    def forward(self, q_in, k_in, v_in):
        wq, wk, wv = self.in_proj_weight.chunk(3)
        return self.out_proj(attention(F.linear(q_in, wq), F.linear(k_in, wk),
                                       F.linear(v_in, wv), self.num_heads))


class EncoderLayer(nn.Module):
    def __init__(self, dim, heads, hidden):
        super().__init__()
        self.self_attn = SelfAttention(dim, heads)
        self.linear1 = nn.Linear(dim, hidden)
        self.linear2 = nn.Linear(hidden, dim)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)

    def forward(self, src):
        src2 = self.norm1(src)
        src = src + self.self_attn(src2, src2, src2)
        return src + self.linear2(F.relu(self.linear1(self.norm2(src))))


class _Layers(nn.Module):
    def __init__(self, spec):
        super().__init__()
        self.layers = nn.ModuleList([EncoderLayer(
            spec.embedding_dim, spec.num_heads, spec.hidden_dim)])


class _Pos(nn.Module):
    def __init__(self, s, e):
        super().__init__()
        self.pe = nn.Embedding(s, e)


class ViT(nn.Module):
    """One LViT or GViT block: one pre-norm layer, the MLP head, learned
    positions added once."""

    def __init__(self, spec: ViTSpec):
        super().__init__()
        self.spec = spec
        e, flat = spec.embedding_dim, spec.patch_dim ** 2 * spec.num_channels
        self.linear_encoding = nn.Linear(flat, e)
        self.mlp_head = nn.Sequential(nn.Linear(e, spec.hidden_dim), nn.ReLU(),
                                      nn.Identity(),
                                      nn.Linear(spec.hidden_dim, flat))
        self.encoder = _Layers(spec)
        self.position_encoding = _Pos(spec.seq_length, e)

    def tokens(self, t):
        t = self.linear_encoding(t) + t
        t = self.encoder.layers[0](t + self.position_encoding.pe.weight)
        return self.mlp_head(t) + t

    def forward(self, x):
        for _ in range(self.spec.global_pools):
            x = F.avg_pool2d(x, 2)
        h, w = x.shape[2:]
        x = fold_tokens(self.tokens(unfold_tokens(x, self.spec.patch_dim)),
                        self.spec.patch_dim, h, w)
        for _ in range(self.spec.global_pools):
            x = F.interpolate(x, scale_factor=2, mode="bilinear",
                              align_corners=False)
        return x


# -- generator --------------------------------------------------------------

@dataclass(frozen=True)
class GenSpec:
    """The switches the reference generator implements (the port's GenSpec
    fields of the same names); a configuration's file sets them."""
    name: str
    n_feats: int = 24
    n_colors: int = 3
    patch_size: int = 32
    patch_dim: int = 2
    num_heads: int = 4
    hidden_dim_ratio: int = 4
    load_size: int = 256
    half_res_trunk: bool = True
    branches: str = "rsd"
    fusion: str = "cat"
    d_skip: str = "cfs"
    ipt_style: bool = False
    separate_encoders: bool = False
    xdh: bool = False
    s_dec_from_r_enc: bool = False
    s_dec1_ru_zero: bool = False
    tail_norm: str = "actnorm"
    s_tail_norm: bool = False
    global_pools: int = 2

    def level_channels(self, lvl):
        return self.n_feats << (lvl - 1)

    def stem_channels(self):
        return self.n_feats // 2 if self.half_res_trunk else self.n_feats

    def lvit_spec(self, lvl):
        c = self.level_channels(lvl)
        e = c * self.patch_dim ** 2
        return ViTSpec(self.patch_size, self.patch_dim, c, e,
                       self.num_heads << (lvl - 1), e * self.hidden_dim_ratio)

    def gvit_spec(self, lvl, encoder):
        c = self.level_channels(lvl)
        pd = 2 * self.patch_dim
        e = c * pd * pd
        hidden = e * self.hidden_dim_ratio
        if encoder and lvl == 2:   # reference quirk: patch_dim, not 2*patch_dim
            hidden = c * self.patch_dim ** 2 * self.hidden_dim_ratio
        return ViTSpec((self.load_size >> (lvl - 1)) >> self.global_pools, pd,
                       c, e, self.num_heads << (lvl - 1), hidden,
                       self.global_pools)


def gen_spec(name: str, switches: dict, **geometry) -> GenSpec:
    """The spec named `name` with a configuration's switches (its file's
    "spec") and geometry; the defaults are v3's."""
    return GenSpec(name=name, **switches, **geometry)


def enc_suffix(spec, b):
    return ("" if b == "r" else b) if spec.separate_encoders else ""


def encoders(spec):
    return [enc_suffix(spec, b) for b in spec.branches] \
        if spec.separate_encoders else [""]


def level_names(spec, encoder, lvl, sfx):
    if encoder:
        return (f"localvit_encoder_0{lvl}{sfx}", f"globalvit_encoder_0{lvl}{sfx}",
                f"lgcat_conv_e0{lvl}{sfx}")
    v = enc_suffix(spec, sfx) if spec.separate_encoders else (
        "" if spec.ipt_style else sfx)
    return (f"localvit_decoder_0{lvl}{v}", f"globalvit_decoder_0{lvl}{v}",
            f"lgcat_conv_d0{lvl}{sfx}")


def us_name(spec, lvl, b):
    if spec.ipt_style:
        return f"us_conv_e0{lvl}{enc_suffix(spec, b)}"
    return f"us_conv_d0{lvl}{b}"


def tail_name(spec, b):
    if spec.separate_encoders:
        return "tail_gray" if b == "s" else "tail_color"
    return {"r": "tail_R", "s": "tail_S", "d": "tail_D"}[b]


class ResBlock(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.body = nn.Sequential(nn.Conv2d(c, c, 3, padding=1), nn.ReLU(),
                                  nn.Conv2d(c, c, 3, padding=1))


class CFSM2G(nn.Module):
    def __init__(self, c):
        super().__init__()

        def fc():
            return nn.Sequential(nn.Conv2d(c, c // 4, 1, bias=False), nn.ReLU(),
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


_POOLS = ((32, "conv1010"), (16, "conv1020"), (8, "conv1030"),
          (4, "conv1040"), (2, "conv1050"))


class SpatialPyramid(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.refine1 = nn.Conv2d(cin, 32, 3, padding=1)
        self.refine2 = nn.Conv2d(32, 32, 3, padding=1)
        for _, name in _POOLS:
            self.add_module(name, nn.Conv2d(32, 16, 1))
        self.refine3 = nn.Sequential(
            nn.Conv2d(32 + 16 * len(_POOLS), 3, 3, padding=1), nn.Tanh())

    def forward(self, x):
        d = F.leaky_relu(self.refine1(x), 0.2)
        d = F.leaky_relu(self.refine2(d), 0.2)
        h, w = d.shape[2:]
        outs = [F.interpolate(F.leaky_relu(getattr(self, name)(
            F.avg_pool2d(d, k)), 0.2), size=(h, w), mode="bilinear",
            align_corners=True) for k, name in _POOLS]
        return torch.tanh(self.refine3(torch.cat(outs + [d], dim=1)))


def _tail(c, out_c, norm):
    slots = [nn.Identity(), nn.Conv2d(c, c, 3, padding=1)]
    if norm is not None:
        slots.append(ActNorm2d(c) if norm == "actnorm" else InstanceNorm())
    slots += [nn.ReLU(), nn.ReflectionPad2d(3), nn.Conv2d(c, out_c, 7),
              nn.Tanh()]
    return nn.Sequential(nn.Sequential(*slots))


class Generator(nn.Module):
    """x [B,3,H,W] in [-1,1] -> {branch: [B,C,H,W]}, "dh" for xdh."""

    def __init__(self, spec: GenSpec):
        super().__init__()
        self.spec = spec
        nf, c0 = spec.n_feats, spec.stem_channels()
        self.head = nn.Sequential(nn.Sequential(
            nn.Conv2d(spec.n_colors, c0, 5, padding=2), ResBlock(c0)))
        if spec.half_res_trunk:
            self.ds_conv_e01 = nn.Sequential(nn.Conv2d(c0, nf, 3, 2, 1))
        for e in encoders(spec):
            for lvl in (1, 2, 3):
                c = spec.level_channels(lvl)
                if lvl > 1:
                    self.add_module(f"ds_conv_e0{lvl}{e}", nn.Sequential(
                        nn.Conv2d(c // 2, c, 3, 2, 1)))
                self._add_level(True, lvl, e)
        for b in spec.branches:
            for lvl in (3, 2, 1):
                self._add_level(False, lvl, b)
            self.add_module(us_name(spec, 3, b), nn.Sequential(up2(4 * nf, 2 * nf)))
            us2 = [up2(2 * nf, nf)] + ([] if spec.ipt_style else [ActNorm2d(nf)])
            self.add_module(us_name(spec, 2, b), nn.Sequential(*us2))
            if spec.half_res_trunk:
                self.add_module(f"us_conv_d01{b}", nn.Sequential(
                    up2(nf, c0), ActNorm2d(c0)))
            if self._has_sk(b):
                for lvl in (3, 2):
                    c = spec.level_channels(lvl - 1)
                    self.add_module(f"sk_conv_d0{lvl}{b}", nn.Sequential(
                        nn.Conv2d(2 * c, c, 1), ActNorm2d(c)))
        if spec.d_skip == "cfs":
            self.cfsm2g_d03d = nn.Sequential(CFSM2G(2 * nf))
            self.cfsm2g_d02d = nn.Sequential(CFSM2G(nf))
        for b in spec.branches:
            norm = spec.tail_norm if (b != "s" or spec.s_tail_norm) else None
            self.add_module(tail_name(spec, b),
                            _tail(c0, 1 if b == "s" else spec.n_colors, norm))
        if spec.xdh:
            self.sp = SpatialPyramid(3 + sum(1 if b == "s" else spec.n_colors
                                             for b in spec.branches))

    def _has_sk(self, b):
        return self.spec.d_skip != "res" and (b != "d" or self.spec.d_skip != "cfs")

    def _add_level(self, encoder, lvl, sfx):
        spec = self.spec
        lname, gname, cname = level_names(spec, encoder, lvl, sfx)
        self.add_module(lname, ViT(spec.lvit_spec(lvl)))
        self.add_module(gname, ViT(spec.gvit_spec(lvl, encoder)))
        if spec.fusion == "cat":
            c = spec.level_channels(lvl)
            self.add_module(cname, nn.Sequential(nn.Conv2d(2 * c, c, 1),
                                                 ActNorm2d(c)))

    def _level(self, x, encoder, lvl, sfx):
        spec = self.spec
        lname, gname, cname = level_names(spec, encoder, lvl, sfx)
        b, _, h, w = x.shape
        ps, pd = spec.patch_size, spec.patch_dim
        lv = join_tiles(fold_tokens(getattr(self, lname).tokens(
            unfold_tokens(split_tiles(x, ps), pd)), pd, ps, ps), b, h, w)
        if spec.s_dec1_ru_zero and not encoder and lvl == 1 and sfx == "s":
            lv = lv.clone()
            lv[:, :, :h // 2, w // 2:] = 0
        gv = getattr(self, gname)(x)
        if spec.fusion != "cat":
            return lv + gv + x
        return F.relu(getattr(self, cname)(torch.cat([lv, gv], dim=1))) + x

    def _upsample(self, x, lvl, b):
        u = getattr(self, us_name(self.spec, lvl, b))(x)
        return F.relu(instance_norm(u) if lvl == 3 or self.spec.ipt_style else u)

    def _skip(self, b, lvl, u, enc_feat, us):
        if b == "d" and self.spec.d_skip == "cfs":
            return getattr(self, f"cfsm2g_d0{lvl}d")[0](u, us["r", lvl],
                                                        us["s", lvl])
        if self.spec.d_skip == "res":
            return u + enc_feat
        return F.relu(getattr(self, f"sk_conv_d0{lvl}{b}")(
            torch.cat([u, enc_feat], dim=1)))

    def _tail_out(self, b, t):
        slots = getattr(self, tail_name(self.spec, b))[0]
        t2 = slots[1](t)
        if isinstance(slots[2], (ActNorm2d, InstanceNorm)):
            t2 = slots[2](t2)
        conv7 = slots[-2]
        return torch.tanh(conv7(F.pad(F.relu(t2), (3, 3, 3, 3), mode="reflect")))

    def forward(self, x, branches: Optional[str] = None, init: bool = False):
        """`branches` "d" runs only what fake_A needs; `init` is the
        ActNorms' data-dependent init pass."""
        norms = [m for m in self.modules() if isinstance(m, ActNorm2d)]
        for m in norms:
            m.init_pass = init
        try:
            return self._forward(x, branches == "d" and self.spec.branches != "d")
        finally:
            for m in norms:
                m.init_pass = False

    def _forward(self, x, d_only):
        spec = self.spec
        conv5, res = self.head[0][0], self.head[0][1].body
        h = conv5(x)
        xf = h + res[2](F.relu(res[0](h)))
        if spec.half_res_trunk:
            xf = F.relu(instance_norm(self.ds_conv_e01(xf)))
        enc = {}
        for e in encoders(spec):
            cur, enc[e] = xf, {}
            for lvl in (1, 2, 3):
                if lvl > 1:
                    cur = F.relu(instance_norm(
                        getattr(self, f"ds_conv_e0{lvl}{e}")(cur)))
                cur = enc[e][lvl] = self._level(cur, True, lvl, e)
        us, d1 = {}, {}
        order = [b for b in "rsd" if b in spec.branches]
        for b in order:
            encs = enc[enc_suffix(spec, b)]
            cur = (enc[enc_suffix(spec, "r")][3]
                   if b == "s" and spec.s_dec_from_r_enc else encs[3])
            full = not d_only or b == "d"
            for lvl in (3, 2):
                cur = self._level(cur, False, lvl, b)
                u = us[b, lvl] = self._upsample(cur, lvl, b)
                if full or lvl == 3:
                    cur = self._skip(b, lvl, u, encs[lvl - 1], us)
            if full:
                d1[b] = self._level(cur, False, 1, b)
        out = {}
        for b in d1:
            t = d1[b] if spec.ipt_style else d1[b] + xf
            if spec.half_res_trunk:
                t = F.relu(getattr(self, f"us_conv_d01{b}")(t))
            out[b] = self._tail_out(b, t)
        if spec.xdh and not d_only:
            out["dh"] = self.sp(torch.cat([x] + [out[b] for b in order], dim=1))
        return out


# -- discriminator ----------------------------------------------------------

class Discriminator(nn.Module):
    """NLayerDiscriminator ("basic", 3 layers), LS-GAN (no sigmoid), on
    cat(hazy, image): 4x4 convs, InstanceNorm after all but the first and
    last, LeakyReLU 0.2."""

    def __init__(self, input_nc: int = 6, ndf: int = 32, n_layers: int = 3):
        super().__init__()

        def block(cin, cout, stride, norm):
            return ([nn.Conv2d(cin, cout, 4, stride, 1)]
                    + ([InstanceNorm()] if norm else []) + [nn.LeakyReLU(0.2)])

        seq, mult = block(input_nc, ndf, 2, False), 1
        for n in range(1, n_layers):
            prev, mult = mult, min(2 ** n, 8)
            seq += block(ndf * prev, ndf * mult, 2, True)
        prev, mult = mult, min(2 ** n_layers, 8)
        seq += block(ndf * prev, ndf * mult, 1, True)
        seq += [nn.Conv2d(ndf * mult, 1, 4, 1, 1)]
        self.model = nn.Sequential(*seq)

    def forward(self, x):
        return self.model(x)
