"""The HLG-ViT IID generator, every `--model_G` spec (counterpart of
cfen_vit_tpu/models/generator.py, its plain path).

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

The other 17 specs (models/registry.py) switch parts of this on GenSpec,
as the JAX generator does: a full-resolution trunk (no ds_conv_e01 or
us_conv_d01; the trunk is the stem's output, without a norm); LViT-only,
GViT-only or ResnetBlock (cnn) levels; add fusion; InstanceNorm lgcat,
tails and sk; the D skip as sk on cat(u, r, s) (cat3), on cat(u, enc)
(enc), u + enc (res) or a 1x1 conv + InstanceNorm on cat(u, partner)
(cat_partner); one encoder per branch (dec_ipt); the SpatialPyramid
refiner of the branch outputs (xdh, output "dh"); and the reference
quirks the JAX GenSpec documents (d02_us_from_s, s_dec_from_r_enc,
s_dec1_ru_zero).  Module names follow each family's reference
state_dict (JAX interop/torch_import.py); the `*_name` functions below
hold the naming and interop/from_jax.py reads them too.  The JAX
package's TPU-only phase-space forms (ops/phase_space.py) are not ported:
they re-express this same plain path for the TPU's lane layout.

With branches="d" (test --out_all) the forward runs only what fake_A
needs: a non-D branch stops after its level-2 upsample (D reads its
upsamples, and with d02_us_from_s S's level-2 output), the non-D tails
and the refiner are skipped.  (JAX leaves that pruning to XLA's
dead-code elimination; eager PyTorch has to do it.)

The first forward of a model with uninitialised ActNorms is the JAX
ANCtx init pass (ops/nn.py actnorm_init_pass).

For training, `remat` checkpoints the regions the JAX generator_apply
checkpoints (torch.utils.checkpoint, non-reentrant): "level" every
encoder and decoder level, "branch" every encoder level and each decoder
branch as one region.  Stem and tails are never checkpointed.  A forward
that still has uninitialised ActNorms (the data-dependent init pass) runs
without remat, as in JAX.  The JAX modes "level_dots" and "vit" were
rejected by measurement there and are not ported.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops import cuda_stem, cuda_tail
from ..ops.nn import (ActNorm2d, InstanceNorm, ResnetBlock, actnorm_init_pass,
                      conv_transpose_up2, instance_norm)
from ..ops.resize import resize_align_corners
from ..ops.tiles import join_tiles, split_tiles
from ..ops.patch import fold_tokens, unfold_tokens
from .vit import ViT, ViTSpec


@dataclass(frozen=True)
class GenSpec:
    """The JAX package's GenSpec, field for field (see its docstrings)."""
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


REMAT_MODES = ("none", "level", "branch")


# -- reference module names (JAX interop/torch_import.py) --------------------

def enc_suffix(spec: GenSpec, b: str) -> str:
    """The suffix of the encoder branch `b` decodes from: dec_ipt runs R's
    encoder unsuffixed and S's with an `s`; the others share one."""
    return ("" if b == "r" else b) if spec.separate_encoders else ""


def encoders(spec: GenSpec) -> list:
    return ([enc_suffix(spec, b) for b in spec.branches]
            if spec.separate_encoders else [""])


def dec_vit_suffix(spec: GenSpec, b: str) -> str:
    """Decoder ViT and ipt upsample suffix: single-decoder files (ipt
    family, iidn) name them without a branch letter, dec_ipt names R's
    unsuffixed."""
    if spec.separate_encoders:
        return enc_suffix(spec, b)
    return "" if spec.ipt_style or spec.branches == "d" else b


def level_names(spec: GenSpec, encoder: bool, lvl: int, sfx: str) -> tuple:
    """(cnn blocks, LViT, GViT, lgcat) of one level; `sfx` is the encoder's
    suffix, or the decoder's branch letter."""
    if encoder:
        return (f"encoder_0{lvl}{sfx}", f"localvit_encoder_0{lvl}{sfx}",
                f"globalvit_encoder_0{lvl}{sfx}", f"lgcat_conv_e0{lvl}{sfx}")
    v = dec_vit_suffix(spec, sfx)
    return (f"decoder_0{lvl}{sfx}", f"localvit_decoder_0{lvl}{v}",
            f"globalvit_decoder_0{lvl}{v}", f"lgcat_conv_d0{lvl}{sfx}")


def us_name(spec: GenSpec, lvl: int, b: str) -> str:
    if spec.ipt_style:      # ref ipt.py:189-192, dec_ipt.py:260-268
        return f"us_conv_e0{lvl}{dec_vit_suffix(spec, b)}"
    return f"us_conv_d0{lvl}{b}"


def has_sk(spec: GenSpec, b: str) -> bool:
    """Whether branch `b` has sk_conv_d03/d02: all but the res skip and
    cfs's D."""
    return spec.d_skip != "res" and (b != "d" or spec.d_skip != "cfs")


def tail_branches(spec: GenSpec) -> list:
    """Branches with a tail of their own: D uses R's where they share."""
    return [b for b in spec.branches
            if not (spec.shared_tails and b == "d" and "r" in spec.branches)]


def tail_of(spec: GenSpec, b: str) -> str:
    """The branch whose tail `b` runs through."""
    return b if b in tail_branches(spec) else "r"


def tail_name(spec: GenSpec, b: str) -> str:
    if spec.ipt_style and not spec.separate_encoders:
        return "tail"
    if spec.separate_encoders or spec.shared_tails or spec.branches == "d":
        return "tail_gray" if b == "s" else "tail_color"
    return {"r": "tail_R", "s": "tail_S", "d": "tail_D"}[b]


def unreached_modules(spec: GenSpec) -> set:
    """Top-level modules on no output's loss path (JAX computes them too,
    and their grads are zero there as here): the xdh refiner where D is
    trained (dh feeds no loss), D's decoder levels 3 and 2 with its
    level-3 upsample and skip where D's level-2 upsample reads S's level 2
    (d02_us_from_s), and dec_ipt's S encoder level 3 (S decodes from R's
    level 3)."""
    dead = set()
    if spec.xdh and "d" in spec.branches:
        dead.add("sp")
    if spec.d02_us_from_s:
        for lvl in (3, 2):
            dead.update(level_names(spec, False, lvl, "d"))
        dead.update((us_name(spec, 3, "d"),
                     "cfsm2g_d03d" if spec.d_skip == "cfs" else "sk_conv_d03d"))
    if spec.s_dec_from_r_enc:
        e = enc_suffix(spec, "s")
        dead.update((f"ds_conv_e03{e}", *level_names(spec, True, 3, e)))
    return dead


def tail_norm(spec: GenSpec, b: str) -> Optional[str]:
    """The norm in the tail's slot 2: "actnorm", "instance" or None (the
    1-channel S tail of most files has none)."""
    return spec.tail_norm if (b != "s" or spec.s_tail_norm) else None


# -- modules -------------------------------------------------------------

class Conv1x1T(nn.ConvTranspose2d):
    """A 1x1 stride-1 conv the reference declares as ConvTranspose2d (the
    sk convs of the lvit/gvit/vit files and cat_partner): weight [in, out,
    1, 1] as in its state_dict.  The JAX package holds it as a conv and
    draws it with a conv's fan-in (`in_channels`)."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 1)


def _sk(spec: GenSpec, b: str, cin: int, cout: int) -> nn.Sequential:
    """The sk_conv Sequential: 1x1 conv (or Conv1x1T) + ActNorm; the
    cat_partner D skip is a Conv1x1T alone (its InstanceNorm has no
    state)."""
    if b == "d" and spec.d_skip == "cat_partner":
        return nn.Sequential(Conv1x1T(cin, cout))
    conv = (Conv1x1T(cin, cout) if spec.sk_conv_transposed
            else nn.Conv2d(cin, cout, 1))
    return nn.Sequential(conv, ActNorm2d(cout))


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


_POOLS = ((32, "conv1010"), (16, "conv1020"), (8, "conv1030"),
          (4, "conv1040"), (2, "conv1050"))


class SpatialPyramid(nn.Module):
    """The xdh refiner (JAX spatial_pyramid_apply): two 3x3 convs to 32
    channels with leaky ReLU 0.2, average pools 32/16/8/4/2 each through a
    1x1 conv to 16 and an align-corners bilinear resize back, the concat
    (pooled maps first, the 32-channel map last), a 3x3 conv to RGB and
    tanh, applied twice as the reference does (its refine3 ends in Tanh and
    its forward wraps that in tanh again)."""

    def __init__(self, cin: int):
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
        outs = [resize_align_corners(
            F.leaky_relu(getattr(self, name)(F.avg_pool2d(d, k)), 0.2), h, w)
            for k, name in _POOLS]
        return torch.tanh(self.refine3(torch.cat(outs + [d], dim=1)))


def _tail(c: int, out_c: int, norm: Optional[str]) -> nn.Sequential:
    """Reference tail slots: [0] upsampler (a no-op here), conv3x3, the
    norm (ActNorm or InstanceNorm, where the spec has one), ReLU,
    ReflectionPad(3), conv7x7, Tanh."""
    slots = [nn.Identity(), nn.Conv2d(c, c, 3, padding=1)]
    if norm is not None:
        slots.append(ActNorm2d(c) if norm == "actnorm" else InstanceNorm())
    slots += [nn.ReLU(), nn.ReflectionPad2d(3), nn.Conv2d(c, out_c, 7),
              nn.Tanh()]
    return nn.Sequential(nn.Sequential(*slots))


class Generator(nn.Module):
    """x [B,3,H,W] in [-1,1] -> {branch: [B,out_c,H,W]} in [-1,1], with
    "dh" [B,3,H,W] for the xdh specs."""

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
                    ds = [nn.Conv2d(c // 2, c, 3, 2, 1)]
                    if spec.ds_norm == "actnorm":
                        ds.append(ActNorm2d(c))
                    self.add_module(f"ds_conv_e0{lvl}{e}", nn.Sequential(*ds))
                self._add_level(True, lvl, e)
        for b in spec.branches:
            for lvl in (3, 2, 1):
                self._add_level(False, lvl, b)
            self.add_module(us_name(spec, 3, b), nn.Sequential(
                conv_transpose_up2(4 * nf, 2 * nf)))
            us2 = [conv_transpose_up2(2 * nf, nf)]
            if not spec.ipt_style:
                us2.append(ActNorm2d(nf))
            self.add_module(us_name(spec, 2, b), nn.Sequential(*us2))
            if spec.half_res_trunk:
                self.add_module(f"us_conv_d01{b}", nn.Sequential(
                    conv_transpose_up2(nf, c0), ActNorm2d(c0)))
            if has_sk(spec, b):
                # the level's upsample with the encoder skip, or for cat3's
                # D with R's and S's upsamples
                parts = 3 if b == "d" and spec.d_skip == "cat3" else 2
                for lvl in (3, 2):
                    c = spec.level_channels(lvl - 1)
                    self.add_module(f"sk_conv_d0{lvl}{b}",
                                    _sk(spec, b, parts * c, c))
        if spec.d_skip == "cfs":
            self.cfsm2g_d03d = nn.Sequential(CFSM2G(2 * nf))
            self.cfsm2g_d02d = nn.Sequential(CFSM2G(nf))
        for b in tail_branches(spec):
            self.add_module(tail_name(spec, b), _tail(
                c0, 1 if b == "s" else spec.n_colors, tail_norm(spec, b)))
        if spec.xdh:   # the image and every output: iidr 9, iids 7
            self.sp = SpatialPyramid(3 + sum(
                1 if b == "s" else spec.n_colors for b in spec.branches))

    def _add_level(self, encoder: bool, lvl: int, sfx: str):
        spec = self.spec
        c = spec.level_channels(lvl)
        cnn, lname, gname, cname = level_names(spec, encoder, lvl, sfx)
        if spec.cnn:
            self.add_module(cnn, nn.Sequential(ResnetBlock(c), ResnetBlock(c)))
            return
        if spec.use_local:
            self.add_module(lname, ViT(spec.lvit_spec(lvl)))
        if spec.use_global:
            self.add_module(gname, ViT(spec.gvit_spec(lvl, encoder)))
        if spec.use_local and spec.use_global and spec.fusion == "cat":
            lg = [nn.Conv2d(2 * c, c, 1)]
            if spec.lgcat_norm == "actnorm":
                lg.append(ActNorm2d(c))
            self.add_module(cname, nn.Sequential(*lg))

    def _level(self, x, encoder: bool, lvl: int, sfx: str):
        """JAX _level: the level's blocks on x, fused, plus x."""
        spec = self.spec
        cnn, lname, gname, cname = level_names(spec, encoder, lvl, sfx)
        if spec.cnn:
            return getattr(self, cnn)(x) + x
        lv = (self._local_vit(getattr(self, lname), x) if spec.use_local
              else None)
        if (lv is not None and spec.s_dec1_ru_zero and not encoder
                and lvl == 1 and sfx == "s"):
            # dec_ipt quirk: the S decoder's level-1 local map keeps a zero
            # top-right quadrant (JAX _level, GenSpec.s_dec1_ru_zero)
            lv = lv.clone()
            lv[:, :, :lv.shape[2] // 2, lv.shape[3] // 2:] = 0
        gv = getattr(self, gname)(x) if spec.use_global else None
        if lv is None or gv is None:
            return (gv if lv is None else lv) + x
        if spec.fusion != "cat":
            return lv + gv + x
        y = getattr(self, cname)(torch.cat([lv, gv], dim=1))
        if spec.lgcat_norm != "actnorm":
            y = instance_norm(y)
        return F.relu(y) + x

    def _local_vit(self, lvit: ViT, x):
        """JAX _local_vit: the shared-weight LViT on every tile, batched;
        v5's shrink and extend on the whole map around it."""
        ps, pd = self.spec.patch_size, lvit.spec.patch_dim
        b, _, h, w = x.shape
        x = lvit.bottleneck("conv_shrink", x)
        t = lvit.tokens(unfold_tokens(split_tiles(x, ps), pd))
        return lvit.bottleneck("conv_extend",
                               join_tiles(fold_tokens(t, pd, ps, ps), b, h, w))

    def _upsample(self, x, lvl, b):
        """ConvTranspose2d(k4, s2, p1), then InstanceNorm (level 3, and
        both levels of the ipt family) or the Sequential's ActNorm, then
        ReLU."""
        u = getattr(self, us_name(self.spec, lvl, b))(x)
        return F.relu(instance_norm(u) if lvl == 3 or self.spec.ipt_style
                      else u)

    def _skip(self, b, lvl, u, enc_feat, us):
        """The decoder's fusion of its level-`lvl` upsample (JAX
        decode_branch)."""
        spec = self.spec
        if b == "d" and spec.d_skip == "cfs":
            cfs = getattr(self, f"cfsm2g_d0{lvl}d")[0]
            return cfs(u, us["r", lvl], us["s", lvl])
        if spec.d_skip == "res":
            return u + enc_feat
        sk = getattr(self, f"sk_conv_d0{lvl}{b}")
        if b == "d" and spec.d_skip == "cat_partner":
            pb = "r" if "r" in spec.branches else "s"
            return F.relu(instance_norm(sk(torch.cat([u, us[pb, lvl]], dim=1))))
        parts = ([u, us["r", lvl], us["s", lvl]]
                 if b == "d" and spec.d_skip == "cat3" else [u, enc_feat])
        return F.relu(sk(torch.cat(parts, dim=1)))

    def _tail_out(self, b, t):
        """conv3x3 (+norm) + ReLU, then the K3 epilogue."""
        slots = getattr(self, tail_name(self.spec, tail_of(self.spec, b)))[0]
        t2 = slots[1](t)
        if isinstance(slots[2], (ActNorm2d, InstanceNorm)):
            t2 = slots[2](t2)
        conv7 = slots[-2]
        return cuda_tail.tail_epilogue(F.relu(t2), conv7.weight, conv7.bias)

    def actnorms_ready(self) -> bool:
        return all(m.ready() for m in self.modules()
                   if isinstance(m, ActNorm2d))

    def _decode_branch(self, b, cur, encs, us, s2, full, level):
        """Levels 3, 2 (and 1 if `full`) of one decoder branch.  encs: the
        encoder features its skips read {2: ..., 1: ...}; us: the R/S
        upsamples D reads; s2: S's level-2 output under d02_us_from_s.
        Returns (level-1 output or None, {3: upsample, 2: upsample},
        level-2 output)."""
        us_b, l2 = {}, None
        for lvl in (3, 2):
            cur = level(cur, False, lvl, b)
            if lvl == 2:
                l2 = cur
            # d02_us_from_s: D's level-2 upsample reads S's level-2 output
            u = us_b[lvl] = self._upsample(
                s2 if s2 is not None and lvl == 2 else cur, lvl, b)
            if full or lvl == 3:
                cur = self._skip(b, lvl, u, encs[lvl - 1], us)
        d1 = level(cur, False, 1, b) if full else None
        return d1, us_b, l2

    def forward(self, x: torch.Tensor, branches: Optional[str] = None,
                remat: str = "none"):
        """`branches` None (or the spec's) runs every output; "d" only
        what fake_A needs."""
        spec = self.spec
        d_only = branches == "d" and spec.branches != "d"
        if branches not in (None, spec.branches) and not d_only:
            raise ValueError(f"branches must be {spec.branches!r} or 'd' "
                             f"for {spec.name}, got {branches!r}")
        if d_only and "d" not in spec.branches:
            raise ValueError(f"{spec.name} has no D branch ({spec.branches})")
        if remat not in REMAT_MODES:
            raise NotImplementedError(
                f"remat mode {remat!r}: the port has {REMAT_MODES} (the JAX "
                "modes level_dots and vit were rejected by measurement)")
        init = not self.actnorms_ready()
        if init:
            remat = "none"      # the init pass sees real statistics
        with actnorm_init_pass(self) if init else contextlib.nullcontext():
            return self._forward(x, d_only, remat)

    def _forward(self, x, d_only, remat):
        spec = self.spec

        def ckpt(fn, *args):
            return checkpoint(fn, *args, use_reentrant=False)

        level = self._level if remat == "none" else (
            lambda *args: ckpt(self._level, *args))
        conv5, res = self.head[0][0], self.head[0][1].body
        xf = cuda_stem.fused_stem(x.contiguous(), conv5.weight, conv5.bias,
                                  res[0].weight, res[0].bias, res[2].weight,
                                  res[2].bias)
        if spec.half_res_trunk:
            xf = F.relu(instance_norm(self.ds_conv_e01(xf)))

        enc = {}
        for e in encoders(spec):
            cur, enc[e] = xf, {}
            for lvl in (1, 2, 3):
                if lvl > 1:
                    cur = getattr(self, f"ds_conv_e0{lvl}{e}")(cur)
                    if spec.ds_norm != "actnorm":
                        cur = instance_norm(cur)
                    cur = F.relu(cur)
                cur = enc[e][lvl] = level(cur, True, lvl, e)

        us, d1, l2 = {}, {}, {}
        order = [b for b in "rsd" if b in spec.branches]
        for b in order:
            encs = enc[enc_suffix(spec, b)]
            # dec_ipt quirk: S decodes from R's level 3 (GenSpec)
            cur = (enc[enc_suffix(spec, "r")][3]
                   if b == "s" and spec.s_dec_from_r_enc else encs[3])
            s2 = l2.get("s") if b == "d" and spec.d02_us_from_s else None
            full = not d_only or b == "d"
            if remat == "branch":
                # a copy of `us`: the region keeps its arguments until the
                # backward has read all it saved, and `us` takes the region's
                # own outputs below, so where the backward never reaches part
                # of it (D's level-2 output under d02_us_from_s) its graph
                # held itself and outlived the step
                out_b, us_b, l2[b] = ckpt(self._decode_branch, b, cur, encs,
                                          dict(us), s2, full, self._level)
            else:
                out_b, us_b, l2[b] = self._decode_branch(
                    b, cur, encs, us, s2, full, level)
            us.update({(b, lvl): u for lvl, u in us_b.items()})
            if full:
                d1[b] = out_b

        out = {}
        for b in d1:
            t = d1[b] if spec.ipt_style else d1[b] + xf
            if spec.half_res_trunk:
                t = F.relu(getattr(self, f"us_conv_d01{b}")(t))
            out[b] = self._tail_out(b, t)
        if spec.xdh and not d_only:
            out["dh"] = self.sp(torch.cat([x] + [out[b] for b in order], dim=1))
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
            # ConvTranspose2d that is out-channels * k * k, as in JAX, but
            # a Conv1x1T is a conv there (fan_in = its input channels)
            fan_in = (m.in_channels if isinstance(m, Conv1x1T)
                      else m.weight[0].numel())
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
