"""K1: block attention for the LViT/GViT token blocks (counterpart of
cfen_vit_tpu/ops/pallas_attn.py).

Replaces the TPU kernel `fused_block_attention` (pallas_attn.py, kernel
`_attn_kernel`) with csrc/attn.cu (the kernel is in csrc/attn.cuh, which
K2 shares): non-causal softmax(Q K^T / sqrt(dh)) V for all heads of
[N, S, E] batch-first tokens.  On Hopper the kernel is
bound by shared-memory reads, not device memory: S <= 256 keeps one head's
logits in shared memory, so the kernel makes two passes over the keys
(logits, then P V) with exact row statistics; see the source's header.

`block_attention` runs `attention_core`, the plain version (JAX
models/vit.py attention_core), for CPU tensors and the kernel for CUDA
tensors; a CUDA input the kernel does not take raises.  Under autograd the
kernel's backward recomputes through `attention_core` and returns its
vector-Jacobian product (the JAX kernel has no VJP: it is off by default
there, so this recompute is the port's choice).
"""

from __future__ import annotations

import math

import torch

from . import _build

launches = 0          # kernel launches since the last reset
recomputes = 0        # backward recomputes through attention_core
HEAD_DIMS = (16, 24, 64, 96)   # the kernel's instantiations (csrc/attn.cuh)
MAX_SEQ = 1024        # the [32, S] logits block must fit in shared memory


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   num_heads: int) -> torch.Tensor:
    """softmax(Q K^T / sqrt(dh)) V per head on [N,S,E] (JAX attention_core).

    Logits, max, exp and sum are float32.  Under bf16 the exp values are
    rounded to bf16 and divided by the bf16-rounded sum, as the JAX
    package does; float32 is a plain softmax."""
    n, s, e = q.shape
    dh = e // num_heads
    scale = 1.0 / math.sqrt(dh)
    qh = (q * scale).reshape(n, s, num_heads, dh).transpose(1, 2)
    kh = k.reshape(n, s, num_heads, dh).transpose(1, 2)
    vh = v.reshape(n, s, num_heads, dh).transpose(1, 2)
    logits = qh.float() @ kh.float().transpose(-1, -2)
    if v.dtype == torch.bfloat16:
        ex = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        denom = ex.sum(dim=-1, keepdim=True)
        probs = ex.to(torch.bfloat16) / denom.to(torch.bfloat16)
    else:
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return (probs @ vh).transpose(1, 2).reshape(n, s, e)


def block_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    num_heads: int) -> torch.Tensor:
    """q, k, v: [N, S, E] -> [N, S, E]."""
    if q.device.type == "cpu":
        return attention_core(q, k, v, num_heads)
    return _Attention.apply(q, k, v, num_heads)


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, num_heads):
        ctx.save_for_backward(q, k, v)
        ctx.num_heads = num_heads
        return _launch(q, k, v, num_heads)

    @staticmethod
    def backward(ctx, g):
        global recomputes
        recomputes += 1
        grads = _build.recompute_vjp(
            lambda q, k, v: attention_core(q, k, v, ctx.num_heads),
            ctx.saved_tensors, ctx.needs_input_grad, g)
        return (*grads, None)


def _launch(q, k, v, num_heads):
    global launches
    _build.check_cuda_inputs("block_attention", q, k, v)
    n, s, e = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"block_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)} differ")
    if e % num_heads or e // num_heads not in HEAD_DIMS or s > MAX_SEQ:
        raise ValueError(f"block_attention: head dim {e / num_heads} (E {e}, "
                         f"{num_heads} heads) not in {HEAD_DIMS} or S {s} > "
                         f"{MAX_SEQ}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _build.library().cfen_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            n, s, e, num_heads, _build.dtype_code(q), _build.stream(q))
    _build.check(rc, "cfen_attn_fwd")
    launches += 1
    return out
