"""K2: the whole ViT token block (counterpart of
cfen_vit_tpu/ops/pallas_vit.py).

Replaces the TPU kernel `_run` (pallas_vit.py, kernel `_kernel`) with
csrc/vit.cu: linear_encoding plus residual, the positional add, pre-norm
bias-free multi-head attention, the MLP and mlp_head plus residual, on
[N, S, E] tokens, rounding where the TPU kernel rounds (every linear in
float32 then once to the compute dtype, LayerNorm in float32, q cast to
float32 before its scale, the softmax divided in float32).  On Hopper the
block is bound by its operations; the kernel cuts it into seven launches
of one tensor-core linear kernel (bf16 mma.sync, float32 3xTF32, fed by a
cp.async ring), two of a LayerNorm kernel and one of the attention kernel
K1 shares, with the intermediates in scratch (see the source's header).

`fused_tokens_plain` is the same arithmetic in plain PyTorch: the tests
and chip_smoke.py hold the kernel against it, and `fused_tokens` runs it
for CPU tensors.  For CUDA tensors `fused_tokens` launches the kernel, or
raises on a block it does not take.  Under autograd the kernel's backward
recomputes through `tokens_reference`, the port's plain token pipeline
with `attention_core`, and returns its vector-Jacobian product, as the JAX
custom VJP does through `_ref_tokens` (pallas_vit.py:191-227).

Dispatch mirrors the JAX package under the same environment names:
`CFEN_PALLAS_VIT=1` switches K2 on (off by default, as there), and
`supported` is pallas_vit.py `supported` verbatim, `CFEN_PALLAS_VIT_MIN_E`
included; models/vit.py `ViT.tokens` asks both.
"""

from __future__ import annotations

import ctypes
import math
import os

import torch
import torch.nn.functional as F

from . import _build, cuda_attn

launches = 0          # kernel launches since the last reset
recomputes = 0        # backward recomputes through tokens_reference
# pallas_vit.py _VMEM_WEIGHT_BUDGET: the TPU kernel's weight budget (bytes
# of bf16), kept so that `supported` admits the blocks JAX admits
_VMEM_WEIGHT_BUDGET = 9 * 1024 * 1024
# the weights in the order fused_tokens takes them, torch [out, in] layout
FUSED_WEIGHTS = ("enc_w", "enc_b", "pos", "ln1_g", "ln1_b", "in_proj", "wo",
                 "ln2_g", "ln2_b", "l1_w", "l1_b", "l2_w", "l2_b", "mh1_w",
                 "mh1_b", "mh2_w", "mh2_b")


def use_fused_vit() -> bool:
    """CFEN_PALLAS_VIT=1 switches K2 on; anything else leaves it off."""
    return os.environ.get("CFEN_PALLAS_VIT", "auto") == "1"


def supported(spec) -> bool:
    """The canonical flags, one layer, S >= 64, E >= CFEN_PALLAS_VIT_MIN_E
    (default 256) and the TPU kernel's bf16 weight budget."""
    if (spec.no_norm or spec.no_mlp or spec.no_pos or spec.pos_every
            or spec.num_layers != 1):
        return False
    if spec.seq_length < 64:
        return False
    e, h = spec.embedding_dim, spec.hidden_dim
    if e < int(os.environ.get("CFEN_PALLAS_VIT_MIN_E", "256")):
        return False
    wbytes = 2 * (5 * e * e + 4 * e * h + spec.seq_length * e)
    return wbytes <= _VMEM_WEIGHT_BUDGET


def fused_tokens_plain(t: torch.Tensor, weights, num_heads: int) -> torch.Tensor:
    """[N, S, E] -> [N, S, E] with the TPU kernel's rounding points
    (pallas_vit.py _kernel :58-106)."""
    (enc_w, enc_b, pos, ln1g, ln1b, in_proj, wo, ln2g, ln2b, l1w, l1b, l2w,
     l2b, mh1w, mh1b, mh2w, mh2b) = weights
    dt = t.dtype
    n, s, e = t.shape
    dh = e // num_heads

    def lin(x, w, b=None):
        y = x.float() @ w.float().t()
        if b is not None:
            y = y + b.float()
        return y.to(dt)

    def ln(x, g, b):
        x32 = x.float()
        mu = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mu).square().mean(dim=-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + 1e-5)
        return (y * g.float() + b.float()).to(dt)

    def heads(x):
        return x.reshape(n, s, num_heads, dh).transpose(1, 2)

    t1 = lin(t, enc_w, enc_b) + t
    t1 = t1 + pos
    q, k, v = lin(ln(t1, ln1g, ln1b), in_proj).split(e, dim=-1)
    scale = 1.0 / math.sqrt(dh)
    logits = (heads(q).float() * scale) @ heads(k).float().transpose(-1, -2)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = (p / p.sum(dim=-1, keepdim=True)).to(dt)
    attn = (p.float() @ heads(v).float()).to(dt).transpose(1, 2).reshape(n, s, e)
    src = t1 + lin(attn, wo)
    src = src + lin(lin(ln(src, ln2g, ln2b), l1w, l1b).relu(), l2w, l2b)
    return lin(lin(src, mh1w, mh1b).relu(), mh2w, mh2b) + src


def tokens_reference(t: torch.Tensor, weights, num_heads: int) -> torch.Tensor:
    """The port's plain token pipeline (models/vit.py ViT.tokens at the
    canonical flags) with `attention_core`: what the kernel's backward
    differentiates."""
    (enc_w, enc_b, pos, ln1g, ln1b, in_proj, wo, ln2g, ln2b, l1w, l1b, l2w,
     l2b, mh1w, mh1b, mh2w, mh2b) = weights
    e = t.shape[-1]
    t = F.linear(t, enc_w, enc_b) + t
    t = t + pos
    src2 = F.layer_norm(t, (e,), ln1g, ln1b)
    wq, wk, wv = in_proj.chunk(3)
    attn = cuda_attn.attention_core(F.linear(src2, wq), F.linear(src2, wk),
                                    F.linear(src2, wv), num_heads)
    t = t + F.linear(attn, wo)
    t = t + F.linear(F.relu(F.linear(F.layer_norm(t, (e,), ln2g, ln2b), l1w,
                                     l1b)), l2w, l2b)
    return F.linear(F.relu(F.linear(t, mh1w, mh1b)), mh2w, mh2b) + t


def fused_tokens(t: torch.Tensor, weights, num_heads: int) -> torch.Tensor:
    """t [N, S, E] and the 17 FUSED_WEIGHTS -> [N, S, E]."""
    if t.device.type == "cpu":
        return fused_tokens_plain(t, weights, num_heads)
    return _FusedTokens.apply(num_heads, t, *weights)


class _FusedTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, num_heads, t, *weights):
        ctx.save_for_backward(t, *weights)
        ctx.num_heads = num_heads
        return _launch(t, weights, num_heads)

    @staticmethod
    def backward(ctx, g):
        global recomputes
        recomputes += 1
        grads = _build.recompute_vjp(
            lambda t, *w: tokens_reference(t, w, ctx.num_heads),
            ctx.saved_tensors, ctx.needs_input_grad[1:], g)
        return (None, *grads)


def scratch_elems(n: int, s: int, e: int, h: int, num_heads: int,
                  dtype: torch.dtype) -> int:
    """The scratch csrc/vit.cu vit_forward lays out: t1, qkv, att, src and
    the hidden (6e + h a row), and at an odd bf16 head dim the padded q, k,
    v (3 heads (dh + 1) a row), each buffer rounded up to 8 elements so
    that it starts on 16 bytes."""
    m, dh = n * s, e // num_heads
    hs = cuda_attn.head_stride(dh, dtype)
    padded = 3 * num_heads * hs if hs != dh else 0

    def r8(v):
        return -(-v // 8) * 8
    return 3 * r8(m * e) + r8(3 * m * e) + r8(m * h) + r8(m * padded)


def _launch(t, weights, num_heads):
    global launches
    _build.check_cuda_inputs("fused_vit_tokens", t, *weights)
    if t.dim() != 3 or len(weights) != len(FUSED_WEIGHTS):
        raise ValueError(f"fused_vit_tokens: takes t [N,S,E] and "
                         f"{len(FUSED_WEIGHTS)} weights, got t "
                         f"{tuple(t.shape)} and {len(weights)}")
    n, s, e = t.shape
    h = weights[9].shape[0]
    want = {"enc_w": (e, e), "enc_b": (e,), "pos": (s, e), "ln1_g": (e,),
            "ln1_b": (e,), "in_proj": (3 * e, e), "wo": (e, e), "ln2_g": (e,),
            "ln2_b": (e,), "l1_w": (h, e), "l1_b": (h,), "l2_w": (e, h),
            "l2_b": (e,), "mh1_w": (h, e), "mh1_b": (h,), "mh2_w": (e, h),
            "mh2_b": (e,)}
    bad = [f"{name} {tuple(w.shape)} (want {want[name]})"
           for name, w in zip(FUSED_WEIGHTS, weights)
           if tuple(w.shape) != want[name]]
    if bad:
        raise ValueError(f"fused_vit_tokens: t {tuple(t.shape)}, weights "
                         f"{', '.join(bad)}")
    # the attention kernel K1 shares (csrc/attn.cuh)
    if e % num_heads or not cuda_attn.takes(e // num_heads, s, t.dtype):
        raise ValueError(f"fused_vit_tokens: head dim {e / num_heads} (E {e}, "
                         f"{num_heads} heads) at S {s} in {t.dtype}")
    out = torch.empty_like(t)
    scratch = torch.empty(scratch_elems(n, s, e, h, num_heads, t.dtype),
                          device=t.device, dtype=t.dtype)
    ptrs = (ctypes.c_void_p * len(weights))(*(w.data_ptr() for w in weights))
    with torch.cuda.device(t.device):
        rc = _build.library().cfen_vit_fwd(
            t.data_ptr(), ptrs, out.data_ptr(), scratch.data_ptr(), n, s, e, h,
            num_heads, _build.dtype_code(t), _build.stream(t))
    _build.check(rc, "cfen_vit_fwd")
    launches += 1
    return out
