"""The tensor-core orderings of K2's linears (csrc/vit.cu) and K6's implicit
GEMM (csrc/deform.cu), emulated in torch on the CPU and held against the
JAX package.

K2 runs each linear c = a w^T over k in stages of 128 bytes (`kBK`, 32
float32 values), each stage's products summed apart and then added to
the float32 sum; in float32 each product is 3xTF32 (`mma::split`: hi =
tf32(x), lo = tf32(x - hi), the two cross terms then hi hi), and its
attention (K1) takes the same route.  The LayerNorm normalises in
float32 and rounds to the compute type where the kernel does.  At a tiny
block (tests/test_torch_port_fused_vit.py's, E 96, S 64, hidden 384)
that emulation meets K2's float32 tolerance against the JAX Pallas kernel
in interpret mode (chip_smoke.py K2_TOL: atol 1e-5 of the largest
|output|, rtol 1e-4); one TF32 pass misses it.

K6 runs K as (tap, channel) in stages of kCC = 32 channels, tap-major,
the channels padded with zeros to a multiple of 32, against the weights
repacked by `pack_kernel` as wp[o][tap][c] and loaded per stage in rows of
the block's output width (64 NT), rows past O zero.  The packer below
indexes the weights as `pack_kernel` does and every padded slot is zero.
The sampled patches are the plain version's (`sample_patches` times the
mask; the kernel forms them bit for bit alike).  In float32 the emulation,
3xTF32 per stage, is held against the JAX XLA `modulated_deform_conv` at
the card's float32 tolerance (atol 1e-4, rtol 1e-5), K 3 and 5.

Last, the scratch each kernel lays out, and that `bench_conv --mode
split`'s edit points are still in the kernel sources.
"""

import math
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from cfen_vit_tpu.ops import deform_conv as JD
from cfen_vit_tpu.ops import pallas_vit as pv
from cfen_vit_tpu_torch import bench_conv
from cfen_vit_tpu_torch.ops import cuda_deform, cuda_vit
from cfen_vit_tpu_torch.ops import deform_conv as TD
from tests.test_torch_port_deform import _draw, _jax, _port
from tests.test_torch_port_fused_vit import _mk, _port_vit
from tests.test_torch_port_tf32_split import matmul_tf32, matmul_tf32x3

K2_FRAC, K2_RTOL = 1e-5, 1e-4     # chip_smoke.py K2_TOL["float32"]
K6_ATOL, K6_RTOL = 1e-4, 1e-5     # chip_smoke.py TOL["float32"]
K_STAGE = 32                      # float32: vit.cu kBK, deform.cu kCC
ROUTES = {"tf32x3": matmul_tf32x3, "tf32": matmul_tf32}


def staged(a, w, matmul):
    """a [m, k] @ w[n, k]^T as the kernels sum it in float32: k in stages
    of 32, each stage's products summed, then added to the sum in order."""
    acc = torch.zeros(a.shape[0], w.shape[0], dtype=torch.float32)
    for k0 in range(0, a.shape[1], K_STAGE):
        acc = acc + matmul(a[:, k0:k0 + K_STAGE], w[:, k0:k0 + K_STAGE].t())
    return acc


def k2_tokens(t, weights, heads, matmul, dtype=torch.float32):
    """cuda_vit.fused_tokens_plain with every product through `matmul` in
    vit.cu's order: the linears staged over k, the attention's QK^T and
    PV (K1's float32 route), each result rounded to `dtype` where the
    kernel rounds."""
    (enc_w, enc_b, pos, ln1g, ln1b, in_proj, wo, ln2g, ln2b, l1w, l1b, l2w,
     l2b, mh1w, mh1b, mh2w, mh2b) = weights
    n, s, e = t.shape
    dh = e // heads

    def rnd(x):
        return x.to(dtype).float()

    def lin(x, w, b=None):   # the epilogue: + bias in float32, one rounding
        y = staged(x.reshape(-1, x.shape[-1]), w, matmul).reshape(*x.shape[:-1], -1)
        return rnd(y if b is None else y + b)

    def ln(x, g, b):         # float32 statistics, the output rounded
        mu = x.mean(dim=-1, keepdim=True)
        var = (x - mu).square().mean(dim=-1, keepdim=True)
        return rnd((x - mu) * torch.rsqrt(var + 1e-5) * g + b)

    def split_heads(x):
        return x.reshape(n, s, heads, dh).transpose(1, 2).reshape(n * heads, s, dh)

    t1 = rnd(rnd(lin(t, enc_w, enc_b) + t) + pos)
    q, k, v = (split_heads(x) for x in lin(ln(t1, ln1g, ln1b), in_proj).split(e, dim=-1))
    logits = torch.stack([matmul(qi * (1.0 / math.sqrt(dh)), ki.t()) for qi, ki in zip(q, k)])
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = rnd(p / p.sum(dim=-1, keepdim=True))
    att = rnd(torch.stack([matmul(pi, vi) for pi, vi in zip(p, v)]))
    att = att.reshape(n, heads, s, dh).transpose(1, 2).reshape(n, s, e)
    src = rnd(t1 + lin(att, wo))
    src = rnd(src + lin(torch.relu(lin(ln(src, ln2g, ln2b), l1w, l1b)), l2w, l2b))
    return rnd(lin(torch.relu(lin(src, mh1w, mh1b)), mh2w, mh2b) + src)


@pytest.fixture(scope="module")
def k2_block():
    """Two token blocks (E 96, S 64, hidden 384, 4 heads) and the JAX Pallas
    kernel's output for them in interpret mode."""
    spec, p, t = _mk(np.random.RandomState(0), 2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pv, "_INTERPRET", True)
        ref = np.asarray(pv.fused_vit_tokens(p, spec, jnp.asarray(t)))
    weights = [w.detach().float() for w in _port_vit(p, spec).fused_weights()]
    return spec, torch.from_numpy(t), weights, ref


@pytest.mark.parametrize("route,meets", [("tf32x3", True), ("tf32", False)])
def test_k2_linears_against_jax_pallas_kernel(k2_block, route, meets):
    spec, t, weights, ref = k2_block
    got = k2_tokens(t, weights, spec.num_heads, ROUTES[route]).numpy()
    err = float(np.abs(got - ref).max())
    ok = bool(np.allclose(got, ref, atol=K2_FRAC * np.abs(ref).max(), rtol=K2_RTOL))
    assert ok is meets, (route, err, float(np.abs(ref).max()))


def pack_weights(w, cp):
    """deform.cu pack_kernel: wp[i] for the flat index i = (o kk + tap) cp
    + c is w[(o c_in + c) kk + tap], zero for c >= c_in."""
    o, c_in, k, _ = w.shape
    kk = k * k
    i = np.arange(o * kk * cp)
    ch, r = i % cp, i // cp
    tap, oc = r % kk, r // kk
    flat = w.reshape(-1).numpy()
    src = (oc * c_in + np.minimum(ch, c_in - 1)) * kk + tap
    return torch.from_numpy(np.where(ch < c_in, flat[src], 0.0).astype(np.float32)
                            ).view(o, kk, cp)


def k6_igemm(x, offset, mask, w, b, stride, pad, dil, matmul):
    """deform.cu's product in its order: for each tap, stages of 32 channels
    of the padded patches against the packed weights' rows, the block's
    output width (64 NT channels, NT as the launcher picks it) with rows
    past O zero; then the bias.  -> NHWC [N, OH, OW, O]."""
    o, c_in, k, _ = w.shape
    cp = -(-c_in // K_STAGE) * K_STAGE
    nt = 1 if o <= 64 else 2 if o <= 128 else 4 if o <= 256 else 8
    bn = -(-o // (64 * nt)) * 64 * nt
    patches = TD.sample_patches(x, offset, k, stride, pad, dil)          # [N,OH,OW,KK,C]
    patches = patches * mask.float().permute(0, 2, 3, 1)[..., None]
    n, oh, ow, kk, _ = patches.shape
    a = F.pad(patches, (0, cp - c_in)).reshape(n * oh * ow, kk, cp)
    wp = pack_weights(w, cp)
    assert not wp[:, :, c_in:].any()          # the padded channels are zero
    wp = F.pad(wp, (0, 0, 0, 0, 0, bn - o))   # cp.async zero-fills rows past O
    acc = torch.zeros(n * oh * ow, bn)
    for tap in range(kk):
        for c0 in range(0, cp, K_STAGE):
            acc = acc + matmul(a[:, tap, c0:c0 + K_STAGE], wp[:, tap, c0:c0 + K_STAGE].t())
    assert not acc[:, o:].any()
    return (acc[:, :o] + b).view(n, oh, ow, o)


# (n, h, w, c, o, k, stride, pad, dilation): C off the 32-channel stage and
# over two of them, O off the n8 tiles and the 64-channel block width
K6_CASES = [(2, 9, 10, 20, 13, 3, 1, 1, 1), (1, 11, 12, 40, 70, 5, 1, 2, 1),
            (1, 11, 12, 33, 9, 3, 2, 1, 2)]


@pytest.mark.parametrize("case", K6_CASES)
def test_k6_ordering_and_packer_against_jax_xla(rng, monkeypatch, case):
    monkeypatch.setenv("CFEN_PALLAS_DCN", "0")
    n, h, w, c, o, k, stride, pad, dil = case
    arrays = _draw(rng, n, h, w, c, o, k, stride, pad, dil, 2.0)
    ref = np.asarray(jax.jit(lambda *a: JD.modulated_deform_conv(*a, stride, pad, dil))(
        *_jax(arrays)))
    got = k6_igemm(*_port(arrays), stride, pad, dil, matmul_tf32x3).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=K6_ATOL, rtol=K6_RTOL)


# The scratch each kernel lays out in the caller's buffer.  K2's
# vit_forward takes t1, att and src at [m, e], qkv at [m, 3e] and the
# hidden at [m, h] (6e + h a row), and at an odd bf16 head dim q, k and v
# padded to 3 heads (dh + 1) a row; each buffer starts on 16 bytes.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,s,e,h,heads", [(2, 4, 96, 384, 4),   # dh 24
                                           (1, 8, 15, 30, 3)])   # dh 5
def test_k2_scratch_is_what_vit_forward_takes(dtype, n, s, e, h, heads):
    m, dh = n * s, e // heads    # m a multiple of 8: no buffer is rounded up
    padded = 3 * heads * (dh + 1) if dtype == torch.bfloat16 and dh % 2 else 0
    assert cuda_vit.scratch_elems(n, s, e, h, heads, dtype) == m * (6 * e + h + padded)


# K6's: x channel-last with C rounded up to 8, the weights K-major with C
# rounded up to 32 and, above 512 output channels only, the patches of
# every 32-pixel tile (twice in float32: their TF32 hi and lo parts).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("o", [512, 513])
def test_k6_scratch_keeps_patches_only_above_512_channels(dtype, o):
    n, c, h, w, k, npix = 2, 20, 9, 11, 3, 99
    base = n * h * w * 24 + o * k * k * 32
    patches = n * 4 * 32 * k * k * 32 * (2 if dtype == torch.float32 else 1)
    want = base + (patches if o > 512 else 0)
    assert cuda_deform.scratch_elems(n, c, h, w, o, k, npix, dtype) == want


# `bench_conv --mode split` compiles its variants by editing a copy of a
# kernel's source at fixed lines: each must still be there.
@pytest.mark.parametrize("kernel,hook", [(k, h) for k, v in bench_conv._SPLITS.items()
                                         for h in v[2]])
def test_split_hooks_are_in_the_kernel_sources(kernel, hook):
    name, _, hooks, _ = bench_conv._SPLITS[kernel]
    source = (Path(bench_conv.__file__).parent / "csrc" / name).read_text()
    assert hooks[hook][0] in source
