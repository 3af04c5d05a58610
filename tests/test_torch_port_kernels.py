"""The port's kernels (cfen_vit_tpu_torch/ops/cuda_{attn,tail,stem,vit,deform}.py).

On the CPU each wrapper runs its plain PyTorch version; those are held
against the JAX package's Pallas kernels, run in interpret mode as
tests/test_pallas_{attn,tail,stem}.py run them, and against the JAX plain
functions, to 3e-5 in float32 (summation order only).

The CUDA kernels themselves are checked against the plain versions by the
tests marked `cuda`, which skip without a card; chip_smoke.py checks them
at the model's full shapes.  K2's plain twin is held against the JAX
Pallas kernel in tests/test_torch_port_fused_vit.py, K6's plain version
against the JAX package in tests/test_torch_port_deform.py.
"""

import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cfen_vit_tpu.models.generator import _stem_plain, _tail_epilogue_plain
from cfen_vit_tpu.models.vit import attention_core as jax_attention_core
from cfen_vit_tpu.ops import nn as JN
from cfen_vit_tpu.ops import pallas_attn, pallas_stem, pallas_tail
from cfen_vit_tpu_torch.models import vit as TV
from cfen_vit_tpu_torch.models.generator import init_weights
from cfen_vit_tpu_torch.ops import cuda_attn, cuda_deform, cuda_stem, cuda_tail, cuda_vit
from cfen_vit_tpu_torch.ops import deform_conv

TOL = 3e-5


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _pallas_attention(q, k, v, heads):
    from jax.experimental import pallas as pl
    n, s, e = q.shape
    kernel = functools.partial(pallas_attn._attn_kernel, heads,
                               1.0 / math.sqrt(e // heads))
    block = pl.BlockSpec((1, s, e), lambda i: (i, 0, 0))
    return pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((n, s, e), q.dtype), grid=(n,),
        in_specs=[block, block, block], out_specs=block, interpret=True)(q, k, v)


@pytest.mark.parametrize("n,s,e,h", [(3, 64, 32, 4), (2, 256, 96, 4),
                                     (2, 16, 128, 2)])
def test_attention_core_matches_jax_pallas(rng, n, s, e, h):
    q, k, v = (rng.randn(n, s, e).astype(np.float32) for _ in range(3))
    got = cuda_attn.attention_core(*map(torch.from_numpy, (q, k, v)), h).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    np.testing.assert_allclose(got, np.asarray(_pallas_attention(jq, jk, jv, h)),
                               atol=TOL)
    np.testing.assert_allclose(got, np.asarray(jax_attention_core(jq, jk, jv, h)),
                               atol=TOL)


def test_attention_core_bf16_rounds_like_jax(rng):
    """bf16: exp values and their sum rounded to bf16 before the divide, as
    in JAX attention_core.  Both sides round the output to bf16, so they
    may differ by a rounding flip: 2 bf16 ulps of |out|."""
    q, k, v = (rng.randn(4, 64, 48).astype(np.float32) for _ in range(3))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = cuda_attn.attention_core(tq, tk, tv, 2)
    assert got.dtype == torch.bfloat16
    ref = np.asarray(jax_attention_core(*(jnp.asarray(a, jnp.bfloat16)
                                          for a in (q, k, v)), 2), np.float32)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=2e-2, rtol=2 ** -7)


@pytest.mark.parametrize("out_c,hh", [(3, 64), (1, 64), (3, 128)])
def test_tail_plain_matches_jax_pallas(rng, monkeypatch, out_c, hh):
    p = JN.conv_init(jax.random.PRNGKey(5), 7, 7, 12, out_c)
    p["b"] = jnp.asarray(rng.randn(out_c).astype(np.float32) * 0.1)
    t2 = rng.randn(2, hh, hh, 12).astype(np.float32)
    w = torch.from_numpy(np.ascontiguousarray(np.asarray(p["w"]).transpose(3, 2, 0, 1)))
    got = nhwc(cuda_tail.tail_plain(nchw(t2), w, torch.tensor(np.asarray(p["b"]))))
    monkeypatch.setattr(pallas_tail, "_INTERPRET", True)
    jt2 = jnp.asarray(t2)
    np.testing.assert_allclose(got, np.asarray(pallas_tail.conv7_tail_epilogue(
        jt2, p["w"], p["b"])), atol=TOL)
    np.testing.assert_allclose(got, np.asarray(_tail_epilogue_plain(jt2, p)), atol=TOL)


def _jax_head(rng):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(3), 3)
    head = {"conv": JN.conv_init(k1, 5, 5, 3, 12),
            "res": {"c1": JN.conv_init(k2, 3, 3, 12, 12),
                    "c2": JN.conv_init(k3, 3, 3, 12, 12)}}
    for conv in (head["conv"], head["res"]["c1"], head["res"]["c2"]):
        conv["b"] = jnp.asarray(rng.randn(12).astype(np.float32) * 0.1)
    return head


def _torch_stem_args(head):
    def conv(p):
        return [torch.from_numpy(np.ascontiguousarray(np.asarray(p["w"]).transpose(3, 2, 0, 1))),
                torch.tensor(np.asarray(p["b"]))]
    return conv(head["conv"]) + conv(head["res"]["c1"]) + conv(head["res"]["c2"])


@pytest.mark.parametrize("hh", [64, 128])
def test_stem_plain_matches_jax_pallas(rng, monkeypatch, hh):
    """Inputs in [-1, 1], the normalised image range the stem sees."""
    head = _jax_head(rng)
    x = rng.uniform(-1, 1, (2, hh, hh, 3)).astype(np.float32)
    got = nhwc(cuda_stem.stem_plain(nchw(x), *_torch_stem_args(head)))
    monkeypatch.setattr(pallas_stem, "_INTERPRET", True)
    jx = jnp.asarray(x)
    np.testing.assert_allclose(got, np.asarray(pallas_stem.fused_stem(jx, head)), atol=TOL)
    np.testing.assert_allclose(got, np.asarray(_stem_plain(jx, head)), atol=TOL)


def test_wrappers_run_plain_on_cpu_without_launching(rng):
    before = (cuda_attn.launches, cuda_tail.launches, cuda_stem.launches)
    q = torch.from_numpy(rng.randn(2, 16, 32).astype(np.float32))
    torch.testing.assert_close(cuda_attn.block_attention(q, q, q, 2),
                               cuda_attn.attention_core(q, q, q, 2), rtol=0, atol=0)
    t2, w, b = torch.randn(1, 12, 8, 8), torch.randn(3, 12, 7, 7), torch.randn(3)
    torch.testing.assert_close(cuda_tail.tail_epilogue(t2, w, b),
                               cuda_tail.tail_plain(t2, w, b), rtol=0, atol=0)
    args = [torch.randn(1, 3, 8, 8)] + _torch_stem_args(_jax_head(rng))
    torch.testing.assert_close(cuda_stem.fused_stem(*args),
                               cuda_stem.stem_plain(*args), rtol=0, atol=0)
    assert (cuda_attn.launches, cuda_tail.launches, cuda_stem.launches) == before


# --------------------------------------------------------------------------
# on the card: each kernel against its plain version
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (atol, rtol): float32 differs in summation order only; bf16 by rounding
# flips of intermediates, ~2 ulps
_CUDA_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 1e-2)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,s,e,h", [(8, 256, 96, 4), (2, 64, 768, 8),
                                     (3, 100, 64, 4)])
def test_cuda_attention_matches_plain(cuda, dtype, n, s, e, h):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(n, s, e, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    before = cuda_attn.launches
    with torch.inference_mode():
        got = cuda_attn.block_attention(q, k, v, h)
        torch.cuda.synchronize()
        ref = cuda_attn.attention_core(q, k, v, h)
    assert cuda_attn.launches == before + 1
    atol, rtol = _CUDA_TOL[dtype]
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [6, 8, 12, 16, 24, 32, 40, 48, 64, 96, 128, 192, 256])
@pytest.mark.parametrize("s", [1, 17, 100, 256, 1024, 4096])
def test_cuda_attention_every_seq_and_head_dim(cuda, dtype, dh, s):
    """The tensor-core K1 at head dims from 6 to 256 (each instantiated
    width; 6, 12 and 40 padded inside the kernel, 6 and 12 loaded in 4- and
    8-byte cp.async chunks in bf16) and S from 1 to 4096, ragged against its
    key tiles and 64-query blocks, resident and streamed."""
    g = torch.Generator(device=cuda).manual_seed(s + dh)
    q, k, v = (torch.randn(2, s, 4 * dh, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    before = cuda_attn.launches
    with torch.inference_mode():
        got = cuda_attn.block_attention(q, k, v, 4)
        torch.cuda.synchronize()
        ref = cuda_attn.attention_core(q, k, v, 4)
    assert cuda_attn.launches == before + 1
    atol, rtol = _CUDA_TOL[dtype]
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [5, 7])
@pytest.mark.parametrize("s", [17, 300])
def test_cuda_attention_odd_head_dims(cuda, dh, s):
    """An odd head dim loads in 4-byte cp.async chunks in float32; in bf16
    no chunk fits a head's row, so the wrapper pads each head to dh + 1
    and the kernel scales by the true dh."""
    g = torch.Generator(device=cuda).manual_seed(s + dh)
    q, k, v = (torch.randn(2, s, 4 * dh, generator=g, device=cuda) for _ in range(3))
    for dtype in (torch.float32, torch.bfloat16):
        a = [t.to(dtype) for t in (q, k, v)]
        before = cuda_attn.launches
        with torch.inference_mode():
            got = cuda_attn.block_attention(*a, 4)
            torch.cuda.synchronize()
            ref = cuda_attn.attention_core(*a, 4)
        assert cuda_attn.launches == before + 1
        atol, rtol = _CUDA_TOL[dtype]
        torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,dh", [(torch.float32, 257), (torch.bfloat16, 257),
                                      (torch.float32, 320), (torch.bfloat16, 320),
                                      (torch.float32, 512), (torch.bfloat16, 512),
                                      (torch.bfloat16, 5), (torch.bfloat16, 33),
                                      (torch.bfloat16, 127)])
@pytest.mark.parametrize("s", [17, 100, 300])
def test_cuda_attention_wide_and_odd_bf16_head_dims(cuda, dtype, dh, s):
    """Head dims above 256 (the head dim streamed in 128-column chunks,
    the output columns split across blocks; 257 odd, padded in bf16) and
    odd bf16 head dims (each head padded by one zero column), at S ragged
    against the key tiles and query blocks."""
    g = torch.Generator(device=cuda).manual_seed(s + dh)
    heads = 2
    q, k, v = (torch.randn(2, s, heads * dh, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    before = cuda_attn.launches
    with torch.inference_mode():
        got = cuda_attn.block_attention(q, k, v, heads)
        torch.cuda.synchronize()
        ref = cuda_attn.attention_core(q, k, v, heads)
    assert cuda_attn.launches == before + 1
    atol, rtol = _CUDA_TOL[dtype]
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_attention_takes_inputs_off_16_byte_alignment(cuda, dtype):
    """Contiguous views that start one element into their storage cannot
    go through cp.async's 16-byte copies; the wrapper copies them to
    aligned storage, and the kernel still launches."""
    g = torch.Generator(device=cuda).manual_seed(3)
    n, s, e = 2, 100, 96
    q, k, v = (torch.randn(n * s * e + 1, generator=g, device=cuda).to(dtype)[1:]
               .view(n, s, e) for _ in range(3))
    assert q.data_ptr() % 16 != 0 and q.is_contiguous()
    before = cuda_attn.launches
    with torch.inference_mode():
        got = cuda_attn.block_attention(q, k, v, 4)
        ref = cuda_attn.attention_core(q, k, v, 4)
    assert cuda_attn.launches == before + 1
    atol, rtol = _CUDA_TOL[dtype]
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)


def _misaligned(t):
    """A contiguous copy of t whose data starts one element (2 bytes in
    bf16, 4 in float32) past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 8, device=t.device, dtype=t.dtype)
    off = (16 - flat.data_ptr() % 16) % 16 // t.element_size() + 1
    view = flat[off:off + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == t.element_size() and view.is_contiguous()
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_c,h,w,n", [(3, 64, 64, 2), (1, 37, 70, 2), (3, 37, 53, 1),
                                         (1, 37, 53, 4)])
@pytest.mark.parametrize("cin", [12, 1, 3, 4, 16, 24, 32, 33])
def test_cuda_tail_matches_plain(cuda, dtype, out_c, h, w, n, cin):
    """cin 12 at n_feats 24, 16 at the defaults, 24 at the full-resolution
    trunk, 4 and 32 at n_feats 8 and 64; 24, 32 and 33 take two or three
    chunks of channels (bf16: 16 a chunk, float32: 8), 33 and 37 x 53 are
    ragged against the chunks and the tiles."""
    g = torch.Generator(device=cuda).manual_seed(1)
    t2 = torch.randn(n, cin, h, w, generator=g, device=cuda).relu().to(dtype)
    wt = (torch.randn(out_c, cin, 7, 7, generator=g, device=cuda)
          * (2 / (49 * cin)) ** 0.5).to(dtype)
    b = (torch.randn(out_c, generator=g, device=cuda) * 0.1).to(dtype)
    before = cuda_tail.launches
    with torch.inference_mode():
        got = cuda_tail.tail_epilogue(t2, wt, b)
        torch.cuda.synchronize()
        ref = cuda_tail.tail_plain(t2, wt, b)
    assert cuda_tail.launches == before + 1
    atol, rtol = _CUDA_TOL[dtype]
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)


def _stem_args(dev, dtype, n, h, w, cm, seed=2):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.rand(n, 3, h, w, generator=g, device=dev) * 2 - 1).to(dtype)
    shapes = [(cm, 3, 5, 5), (cm,), (cm, cm, 3, 3), (cm,), (cm, cm, 3, 3), (cm,)]
    stds = [(2 / 75) ** 0.5, 0.1, (2 / (9 * cm)) ** 0.5, 0.1, (2 / (9 * cm)) ** 0.5, 0.1]
    return [x] + [(torch.randn(s, generator=g, device=dev) * std).to(dtype)
                  for s, std in zip(shapes, stds)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w,n", [(64, 64, 2), (45, 70, 2), (37, 53, 1), (37, 53, 4)])
@pytest.mark.parametrize("cm", [12, 1, 4, 16, 24, 32, 64, 130, 146])
def test_cuda_stem_matches_plain(cuda, dtype, h, w, n, cm):
    """cm 12 at n_feats 24, 16 at the defaults, 4 and 32 at n_feats 8 and
    64; 1 and 24 ragged against the N chunks, 64, 130 and 146 take the
    kernel's smaller tiles and several N chunks."""
    args = _stem_args(cuda, dtype, n, h, w, cm)
    before = cuda_stem.launches
    with torch.inference_mode():
        got = cuda_stem.fused_stem(*args)
        torch.cuda.synchronize()
        ref = cuda_stem.stem_plain(*args)
    assert cuda_stem.launches == before + 1
    atol, rtol = _CUDA_TOL[dtype]
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_tail_and_stem_take_inputs_off_16_byte_alignment(cuda, dtype):
    """Inputs and weights one element past a 16-byte boundary: K3 and K4
    stage through registers (bf16) or 4-byte cp.async copies (float32),
    so they launch on them as they are."""
    g = torch.Generator(device=cuda).manual_seed(6)
    t2 = torch.randn(2, 12, 37, 53, generator=g, device=cuda).relu().to(dtype)
    wt = (torch.randn(3, 12, 7, 7, generator=g, device=cuda) * 0.06).to(dtype)
    b = (torch.randn(3, generator=g, device=cuda) * 0.1).to(dtype)
    stem = _stem_args(cuda, dtype, 2, 37, 53, 12, seed=7)
    atol, rtol = _CUDA_TOL[dtype]
    before = (cuda_tail.launches, cuda_stem.launches)
    with torch.inference_mode():
        got = cuda_tail.tail_epilogue(*map(_misaligned, (t2, wt, b)))
        torch.testing.assert_close(got.float(), cuda_tail.tail_plain(t2, wt, b).float(),
                                   atol=atol, rtol=rtol)
        got = cuda_stem.fused_stem(*map(_misaligned, stem))
        torch.testing.assert_close(got.float(), cuda_stem.stem_plain(*stem).float(),
                                   atol=atol, rtol=rtol)
    assert (cuda_tail.launches, cuda_stem.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.randn(2, 16, 528, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        cuda_attn.block_attention(q, q, q, 5)            # 5 heads do not divide E 528
    with pytest.raises(TypeError):
        cuda_attn.block_attention(q.half(), q.half(), q.half(), 2)
    w = torch.randn(3, 12, 7, 7, device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_tail.tail_epilogue(torch.randn(1, 12, 8, 8, device=cuda), w.transpose(2, 3),
                                torch.randn(3, device=cuda))


def _grads_through(fn, args):
    """Output and the grads of sum(out * cotangent) w.r.t. every float arg."""
    leaves = [a.detach().clone().requires_grad_() if isinstance(a, torch.Tensor) else a
              for a in args]
    out = fn(*leaves)
    cot = torch.randn(out.shape, generator=torch.Generator(device=out.device).manual_seed(9),
                      device=out.device).to(out.dtype)
    grads = torch.autograd.grad(out, [a for a in leaves if isinstance(a, torch.Tensor)], cot)
    return out, grads


def _autograd_cases(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(4)
    rn = lambda *s, std=1.0: (torch.randn(s, generator=g, device=dev) * std).to(dtype)  # noqa: E731
    return [
        ("attention", cuda_attn, cuda_attn.block_attention, cuda_attn.attention_core,
         [rn(8, 256, 96), rn(8, 256, 96), rn(8, 256, 96), 4]),
        ("tail", cuda_tail, cuda_tail.tail_epilogue, cuda_tail.tail_plain,
         [rn(2, 12, 40, 36).relu(), rn(3, 12, 7, 7, std=0.06), rn(3, std=0.1)]),
        ("stem", cuda_stem, cuda_stem.fused_stem, cuda_stem.stem_plain,
         [rn(2, 3, 45, 64)] + [rn(*s, std=0.15) for s in
                                ((12, 3, 5, 5), (12,), (12, 12, 3, 3), (12,),
                                 (12, 12, 3, 3), (12,))]),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_autograd_functions_match_plain_autograd(cuda, dtype):
    """K1, K3 and K4 under autograd: the kernel forward, and a backward that
    recomputes through the plain version, against autograd of the plain
    version.  Both backwards run the same ops on the same inputs; they may
    differ by cuDNN's atomic weight-gradient sums, so grads are held to
    rtol 1e-4 (float32) or 1e-2 (bf16) and that share of their largest
    value."""
    atol, rtol = _CUDA_TOL[dtype]
    grad_rtol = 1e-4 if dtype == torch.float32 else 1e-2
    for name, mod, wrapper, plain, args in _autograd_cases(cuda, dtype):
        before = (mod.launches, mod.recomputes)
        out, grads = _grads_through(wrapper, args)
        ref, ref_grads = _grads_through(plain, args)
        torch.cuda.synchronize()
        assert (mod.launches, mod.recomputes) == (before[0] + 1, before[1] + 1), name
        torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol, msg=name)
        for a, b in zip(grads, ref_grads):
            torch.testing.assert_close(a.float(), b.float(), rtol=grad_rtol,
                                       atol=grad_rtol * b.float().abs().max().item(),
                                       msg=name)


# --------------------------------------------------------------------------
# K2, the whole ViT token block, on the card
# --------------------------------------------------------------------------

# (atol as a share of the largest |output|, rtol).  float32: summation
# order through eight chained linears; bf16: a rounding flip of an
# intermediate moves an output by about one bf16 ulp of the residual stream.
_K2_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2 ** -7, 1e-2)}


def _k2_block(dev, dtype, n, s, e, heads, seed=5, ratio=4):
    """A ViT block (hidden ratio e) with the generator's init, random biases
    and LayerNorm affines, on the card in dtype, and seeded tokens."""
    g = torch.Generator().manual_seed(seed)
    pd = 2 if e % 4 == 0 else 1    # an E of no 2x2 patch: 1x1 patches
    spec = TV.ViTSpec(img_dim=int(s ** 0.5) * pd, patch_dim=pd, num_channels=e // pd ** 2,
                      embedding_dim=e, num_heads=heads, num_layers=1,
                      hidden_dim=ratio * e)
    vit = init_weights(TV.ViT(spec), g)
    with torch.no_grad():
        for name, prm in vit.named_parameters():
            if name.endswith("bias") or "norm" in name:
                prm.add_(torch.randn(prm.shape, generator=g) * 0.1)
    t = torch.randn(n, spec.seq_length, e, generator=g)
    return spec, vit.to(dev, dtype).eval(), t.to(dev, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,s,e,heads", [(2, 256, 384, 16), (3, 64, 96, 4),
                                         (2, 100, 64, 4),
                                         (8, 256, 96, 4),     # LViT L1, dh 24
                                         (4, 256, 384, 4),    # GViT L1, dh 96
                                         (4, 256, 512, 4),    # GViT L1 at the defaults, dh 128
                                         (2, 64, 384, 32),    # dh 12, padded
                                         (2, 64, 20, 4),      # dh 5: odd, padded heads in bf16
                                         (1, 64, 1280, 4),    # dh 320: the wide attention
                                         # the linears' tiles: m 300 (no row
                                         # tile divides it) at E 96 / 3E 288,
                                         # m 320 at E 192, odd bf16 rows (E 99)
                                         (3, 100, 96, 4), (5, 64, 192, 8),
                                         (2, 64, 99, 3)])
def test_cuda_fused_vit_matches_twin(cuda, dtype, n, s, e, heads):
    spec, vit, t = _k2_block(cuda, dtype, n, s, e, heads)
    w = vit.fused_weights()
    before = cuda_vit.launches
    with torch.inference_mode():
        got = cuda_vit.fused_tokens(t, w, heads)
        torch.cuda.synchronize()
        ref = cuda_vit.fused_tokens_plain(t, w, heads)
    assert cuda_vit.launches == before + 1
    frac, rtol = _K2_TOL[dtype]
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol,
                               atol=frac * ref.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_fused_vit_defaults_lvit_l2(cuda, dtype):
    """The JAX package's default flags admit LViT L2 at [64, 256, 256] with
    hidden 1536 (n_feats 32, hidden_dim_ratio 6, head dim 32): its MLP
    linears take k 1536."""
    spec, vit, t = _k2_block(cuda, dtype, 64, 256, 256, 8, ratio=6)
    w = vit.fused_weights()
    with torch.inference_mode():
        got = cuda_vit.fused_tokens(t, w, 8)
        torch.cuda.synchronize()
        ref = cuda_vit.fused_tokens_plain(t, w, 8)
    frac, rtol = _K2_TOL[dtype]
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol,
                               atol=frac * ref.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile", [0, 1, 2, 3, -1])
@pytest.mark.parametrize("m,n,k", [(300, 200, 1000),   # 16-byte epilogue
                                   (300, 198, 999)])   # element epilogue, odd k
def test_cuda_vit_linear_every_tile_matches_plain(cuda, dtype, tile, m, n, k):
    """K2's linear kernel alone on each block tile of csrc/vit.cu (and on
    the one `pick` chooses, tile -1): relu(a w^T + bias), the bias added in
    float32 and rounded once, against the float32 product rounded alike.
    No tile divides m or n, and k runs past several ring stages."""
    import ctypes
    from cfen_vit_tpu_torch.ops import _build
    g = torch.Generator(device=cuda).manual_seed(3)
    a = torch.randn(m, k, generator=g, device=cuda).to(dtype)
    w = (torch.randn(n, k, generator=g, device=cuda) * k ** -0.5).to(dtype)
    b = (torch.randn(n, generator=g, device=cuda) * 0.1).to(dtype)
    out = torch.empty(m, n, device=cuda, dtype=dtype)
    used = ctypes.c_int(-2)
    rc = _build.library().cfen_vit_linear(
        a.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, tile,
        _build.dtype_code(a), ctypes.byref(used), _build.stream(a))
    _build.check(rc, "cfen_vit_linear")
    torch.cuda.synchronize()
    assert used.value == tile if tile >= 0 else 0 <= used.value <= 3
    ref = torch.relu((a.float() @ w.float().t() + b.float()).to(dtype)).float()
    frac, rtol = _K2_TOL[dtype]
    torch.testing.assert_close(out.float(), ref, rtol=rtol,
                               atol=frac * ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_fused_vit_grads_match_twin_autograd(cuda, dtype):
    """The kernel forward and its backward, a recompute through
    tokens_reference: the grads are that function's own autograd (to 1e-5
    in relative norm) and, per tensor in relative norm, within 1e-4 of
    autograd through the twin in float32.  In bf16 the two are different
    backward pipelines (the twin's passes through float32 matmuls), so a
    K2 grad must lie within twice the twin's own bf16 error against the
    float32 grads, plus 1e-3."""
    spec, vit, t = _k2_block(cuda, dtype, 2, 64, 96, 4)
    args = [t] + [w.detach() for w in vit.fused_weights()]
    before = (cuda_vit.launches, cuda_vit.recomputes)
    out, grads = _grads_through(lambda x, *w: cuda_vit.fused_tokens(x, w, 4), args)
    _, want = _grads_through(lambda x, *w: cuda_vit.tokens_reference(x, w, 4), args)
    twin = lambda x, *w: cuda_vit.fused_tokens_plain(x, w, 4)   # noqa: E731
    ref, ref_grads = _grads_through(twin, args)
    _, f32_grads = _grads_through(twin, [a.float() for a in args])
    torch.cuda.synchronize()
    assert (cuda_vit.launches, cuda_vit.recomputes) == (before[0] + 1, before[1] + 1)
    frac, rtol = _K2_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                               atol=frac * ref.float().abs().max().item())

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()
    for name, a, b, c, d in zip(("t",) + cuda_vit.FUSED_WEIGHTS, grads, want,
                                ref_grads, f32_grads):
        assert rel(a, b) < 1e-5, name
        bar = 1e-4 if dtype == torch.float32 else 2 * rel(c, d) + 1e-3
        assert rel(a, c) < bar, name


@pytest.mark.cuda
def test_cuda_fused_vit_rejects_what_it_does_not_take(cuda, monkeypatch):
    spec, vit, t = _k2_block(cuda, torch.float32, 1, 64, 96, 4)
    w = list(vit.fused_weights())
    with pytest.raises(ValueError, match="head dim"):
        cuda_vit.fused_tokens(t, w, 5)                       # 5 heads in E 96
    with pytest.raises(TypeError):
        cuda_vit.fused_tokens(t.half(), [x.half() for x in w], 4)
    with pytest.raises(ValueError, match="pos"):
        cuda_vit.fused_tokens(t[:, :32].contiguous(), w, 4)   # S 32 against pos [64, E]
    # every block `supported` admits now runs on the switched-on path: E
    # 264 in one head is head dim 264, K1's wide attention inside K2
    monkeypatch.setenv("CFEN_PALLAS_VIT", "1")
    spec, vit, t = _k2_block(cuda, torch.float32, 1, 64, 264, 1)
    assert cuda_vit.supported(spec)
    before = cuda_vit.launches
    with torch.inference_mode():
        got = vit.tokens(t)
        ref = cuda_vit.fused_tokens_plain(t, vit.fused_weights(), 1)
    assert cuda_vit.launches == before + 1
    frac, rtol = _K2_TOL[torch.float32]
    torch.testing.assert_close(got, ref, rtol=rtol, atol=frac * ref.abs().max().item())


@pytest.mark.cuda
def test_cuda_vit_tokens_switch_launches_k2_once(cuda, monkeypatch):
    spec, vit, t = _k2_block(cuda, torch.float32, 2, 256, 384, 16)
    before = (cuda_vit.launches, cuda_attn.launches)
    monkeypatch.setenv("CFEN_PALLAS_VIT", "1")
    with torch.inference_mode():
        fused = vit.tokens(t)
        monkeypatch.setenv("CFEN_PALLAS_VIT", "0")
        plain = vit.tokens(t)
    assert (cuda_vit.launches, cuda_attn.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(fused, plain, rtol=1e-4,
                               atol=1e-5 * plain.abs().max().item())


# --------------------------------------------------------------------------
# K6, the deformable convolution, on the card
# --------------------------------------------------------------------------

def _deform_args(dev, dtype, n, h, w, c, o, k, stride, pad, dil, off_scale, seed=6):
    g = torch.Generator(device=dev).manual_seed(seed)
    oh, ow = (deform_conv.out_size(s, k, stride, pad, dil) for s in (h, w))
    rn = lambda *s, std=1.0: (torch.randn(s, generator=g, device=dev) * std).to(dtype)  # noqa: E731
    mask = torch.rand((n, k * k, oh, ow), generator=g, device=dev).to(dtype)
    return [rn(n, c, h, w), rn(n, 2 * k * k, oh, ow, std=off_scale), mask,
            rn(o, c, k, k, std=0.05), rn(o, std=0.1)]


# (n, h, w, c, o, k, stride, pad, dilation, offset std); the last case puts
# about a third of the offsets beyond the TPU kernel's ±12 window
_DEFORM_CASES = [(2, 16, 20, 24, 40, 3, 1, 1, 1, 2.0),
                 (1, 33, 30, 20, 70, 5, 1, 2, 1, 2.0),
                 (2, 17, 19, 8, 16, 3, 2, 1, 2, 12.0),
                 # the implicit GEMM's edges: C 33 (a 32-channel stage and
                 # one channel), O 13 (off the n8 tiles), O 130 at K 5 (past
                 # a 128-channel block), O 256, O 600 (past 512: two chunks,
                 # the second on the patches the first kept), O 1100 at K 5,
                 # stride 2 (three chunks, the last ragged)
                 (2, 15, 18, 33, 13, 3, 1, 1, 1, 2.0),
                 (2, 19, 17, 20, 130, 5, 1, 2, 1, 2.0),
                 (1, 20, 21, 64, 256, 3, 1, 1, 1, 2.0),
                 (1, 12, 13, 40, 600, 3, 1, 1, 1, 2.0),
                 (2, 9, 11, 20, 1100, 5, 2, 2, 1, 2.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", _DEFORM_CASES)
def test_cuda_deform_matches_plain(cuda, dtype, case):
    n, h, w, c, o, k, stride, pad, dil, scale = case
    args = _deform_args(cuda, dtype, *case)
    before = cuda_deform.launches
    with torch.inference_mode():
        got = deform_conv.modulated_deform_conv(*args, stride, pad, dil)
        torch.cuda.synchronize()
        ref = deform_conv.deform_plain(*args, stride, pad, dil)
    assert cuda_deform.launches == before + 1
    atol, rtol = _CUDA_TOL[dtype]
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_deform_grads_match_plain_autograd(cuda, dtype):
    """The kernel forward and its backward, a recompute through deform_plain:
    all five grads (four without a bias) against autograd of deform_plain.
    Both backwards run the same operations; the scatter of the x grad adds
    with atomics, so grads are held to rtol 1e-4 (float32) or 1e-2 (bf16)
    and that share of their largest value."""
    atol, rtol = _CUDA_TOL[dtype]
    grad_rtol = 1e-4 if dtype == torch.float32 else 1e-2
    case = (2, 17, 19, 8, 16, 3, 2, 1, 2, 2.0)
    args = _deform_args(cuda, dtype, *case)
    for inputs in (args, args[:4] + [None]):
        before = (cuda_deform.launches, cuda_deform.recomputes)
        out, grads = _grads_through(
            lambda *a: deform_conv.modulated_deform_conv(*a, 2, 1, 2), inputs)
        ref, ref_grads = _grads_through(
            lambda *a: deform_conv.deform_plain(*a, 2, 1, 2), inputs)
        torch.cuda.synchronize()
        assert (cuda_deform.launches, cuda_deform.recomputes) == (before[0] + 1,
                                                                  before[1] + 1)
        assert len(grads) == sum(t is not None for t in inputs)
        torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
        for a, b in zip(grads, ref_grads):
            torch.testing.assert_close(a.float(), b.float(), rtol=grad_rtol,
                                       atol=grad_rtol * b.float().abs().max().item())


@pytest.mark.cuda
def test_cuda_deform_rejects_what_the_kernel_does_not_take(cuda):
    args = _deform_args(cuda, torch.float32, 1, 8, 8, 4, 4, 3, 1, 1, 1, 1.0)
    x, off, mask, w, b = args
    with pytest.raises(TypeError):                          # mixed dtypes
        deform_conv.modulated_deform_conv(x, off, mask, w.bfloat16(), b)
    with pytest.raises(ValueError, match="contiguous"):
        deform_conv.modulated_deform_conv(x, off.transpose(2, 3), mask, w, b)
    with pytest.raises(ValueError, match="must be on"):     # weights on the CPU
        deform_conv.modulated_deform_conv(x, off, mask, w.cpu(), b)
    with pytest.raises(ValueError, match="K 3 or 5"):
        deform_conv.modulated_deform_conv(x, off, mask, w[:, :, :2, :2].contiguous(), b)
    with pytest.raises(ValueError, match="offset"):
        deform_conv.modulated_deform_conv(x, off[:, :9].contiguous(), mask, w, b)
