"""The port's kernels (cfen_vit_tpu_torch/ops/cuda_{attn,tail,stem,vit}.py).

On the CPU each wrapper runs its plain PyTorch version; those are held
against the JAX package's Pallas kernels, run in interpret mode as
tests/test_pallas_{attn,tail,stem}.py run them, and against the JAX plain
functions, to 3e-5 in float32 (summation order only).

The CUDA kernels themselves are checked against the plain versions by the
tests marked `cuda`, which skip without a card; chip_smoke.py checks them
at the model's full shapes.  K2's plain twin is held against the JAX
Pallas kernel in tests/test_torch_port_fused_vit.py.
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
from cfen_vit_tpu_torch.ops import cuda_attn, cuda_stem, cuda_tail, cuda_vit

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
@pytest.mark.parametrize("out_c,h,w", [(3, 64, 64), (1, 37, 70)])
def test_cuda_tail_matches_plain(cuda, dtype, out_c, h, w):
    g = torch.Generator(device=cuda).manual_seed(1)
    t2 = torch.randn(2, 12, h, w, generator=g, device=cuda).relu().to(dtype)
    wt = (torch.randn(out_c, 12, 7, 7, generator=g, device=cuda) * 0.06).to(dtype)
    b = (torch.randn(out_c, generator=g, device=cuda) * 0.1).to(dtype)
    with torch.inference_mode():
        got = cuda_tail.tail_epilogue(t2, wt, b)
        torch.cuda.synchronize()
        ref = cuda_tail.tail_plain(t2, wt, b)
    atol, rtol = _CUDA_TOL[dtype]
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w", [(64, 64), (45, 70)])
def test_cuda_stem_matches_plain(cuda, dtype, h, w):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = (torch.rand(2, 3, h, w, generator=g, device=cuda) * 2 - 1).to(dtype)
    shapes = [(12, 3, 5, 5), (12,), (12, 12, 3, 3), (12,), (12, 12, 3, 3), (12,)]
    args = [(torch.randn(s, generator=g, device=cuda) * 0.15).to(dtype) for s in shapes]
    with torch.inference_mode():
        got = cuda_stem.fused_stem(x, *args)
        torch.cuda.synchronize()
        ref = cuda_stem.stem_plain(x, *args)
    atol, rtol = _CUDA_TOL[dtype]
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.randn(2, 16, 40, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        cuda_attn.block_attention(q, q, q, 4)            # dh 10
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


def _k2_block(dev, dtype, n, s, e, heads, seed=5):
    """A ViT block with the generator's init, random biases and LayerNorm
    affines, on the card in dtype, and seeded tokens."""
    g = torch.Generator().manual_seed(seed)
    spec = TV.ViTSpec(img_dim=int(s ** 0.5) * 2, patch_dim=2, num_channels=e // 4,
                      embedding_dim=e, num_heads=heads, num_layers=1, hidden_dim=4 * e)
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
                                         (2, 100, 64, 4)])
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
        cuda_vit.fused_tokens(t, w, 8)                       # dh 12
    with pytest.raises(TypeError):
        cuda_vit.fused_tokens(t.half(), [x.half() for x in w], 4)
    with pytest.raises(ValueError, match="pos"):
        cuda_vit.fused_tokens(t[:, :32].contiguous(), w, 4)   # S 32 against pos [64, E]
    # a block `supported` admits but the kernel does not take raises on
    # the switched-on path: E 320 in 32 heads is head dim 10
    monkeypatch.setenv("CFEN_PALLAS_VIT", "1")
    spec, vit, t = _k2_block(cuda, torch.float32, 1, 64, 320, 32)
    assert cuda_vit.supported(spec)
    with pytest.raises(ValueError, match="head dim"):
        vit.tokens(t)


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
