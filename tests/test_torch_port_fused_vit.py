"""K2, the whole ViT token block (cfen_vit_tpu_torch/ops/cuda_vit.py), on
the CPU: its plain twin `fused_tokens_plain` against the JAX Pallas kernel
`fused_vit_tokens` run in interpret mode (as tests/test_pallas_vit.py runs
it), `ViT.tokens` and the tiny generator with CFEN_PALLAS_VIT=1 against
the JAX plain path, the `supported` matrix against JAX, and the autograd
Function's recompute.  Weights cross through interop/from_jax.py.

Bars: the twin against the Pallas kernel to atol 5e-5, rtol 1e-4 in
float32 (tests/test_pallas_vit.py's bar) and atol 2e-2, rtol 1e-2 in
bf16 (both round at the same points; a rounding flip of an intermediate
moves an output by about one bf16 ulp); ViT.tokens and the generator to
2e-4 in float32 (the JAX package's golden bar).  The CUDA kernel itself
is held against the twin by the `cuda`-marked tests in
tests/test_torch_port_kernels.py and by chip_smoke.py.
"""

import dataclasses
import os
import subprocess
import sys
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cfen_vit_tpu.models import generator as JG
from cfen_vit_tpu.models import registry as JR
from cfen_vit_tpu.models.vit import ViTSpec as JaxViTSpec, vit_init, vit_tokens_apply
from cfen_vit_tpu.ops import pallas_vit as pv
from cfen_vit_tpu.interop.torch_import import import_generator_state_dict
from cfen_vit_tpu_torch.interop import from_jax as FJ
from cfen_vit_tpu_torch.models import registry as TR
from cfen_vit_tpu_torch.models import vit as TV
from cfen_vit_tpu_torch.models.generator import Generator, init_weights
from cfen_vit_tpu_torch.ops import cuda_vit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mk(rng, n_tiles, img_dim=16, pd=2, c=24, heads=4, ratio=4):
    """tests/test_pallas_vit.py's block: E 96, S 64, hidden 384, with the
    biases and LayerNorm affines made non-trivial so every term counts."""
    spec = JaxViTSpec(img_dim=img_dim, patch_dim=pd, num_channels=c,
                      embedding_dim=c * pd * pd, num_heads=heads, num_layers=1,
                      hidden_dim=c * pd * pd * ratio)
    p = jax.tree_util.tree_map(np.asarray, vit_init(jax.random.PRNGKey(3), spec))
    layer = p["layers"][0]
    for d in (p["linear_encoding"], p["mlp_head"]["l1"], p["mlp_head"]["l2"],
              layer["linear1"], layer["linear2"]):
        d["b"] = rng.randn(*d["b"].shape).astype(np.float32) * 0.1
    for norm in ("norm1", "norm2"):
        layer[norm]["g"] = 1 + rng.randn(spec.embedding_dim).astype(np.float32) * 0.1
        layer[norm]["b"] = rng.randn(spec.embedding_dim).astype(np.float32) * 0.1
    t = rng.randn(n_tiles, spec.seq_length, spec.flatten_dim).astype(np.float32)
    return spec, p, t


def _port_vit(p, spec):
    sd = {}
    FJ._vit(sd, "v", p)
    vit = TV.ViT(TV.ViTSpec(**dataclasses.asdict(spec)))
    vit.load_state_dict({k[2:]: torch.tensor(np.ascontiguousarray(v))
                         for k, v in sd.items()}, strict=True)
    return vit.eval()


@pytest.fixture
def k2_on(monkeypatch):
    monkeypatch.setenv("CFEN_PALLAS_VIT", "1")
    monkeypatch.setenv("CFEN_PALLAS_VIT_MIN_E", "0")


@pytest.fixture
def twin_calls(monkeypatch):
    calls = []
    plain = cuda_vit.fused_tokens_plain

    def spy(t, weights, num_heads):
        calls.append(tuple(t.shape))
        return plain(t, weights, num_heads)
    monkeypatch.setattr(cuda_vit, "fused_tokens_plain", spy)
    return calls


@pytest.mark.parametrize("n_tiles", [3, 8])
def test_twin_matches_jax_pallas_kernel(rng, monkeypatch, n_tiles):
    spec, p, t = _mk(rng, n_tiles)
    monkeypatch.setattr(pv, "_INTERPRET", True)
    ref = pv.fused_vit_tokens(p, spec, jnp.asarray(t))
    vit = _port_vit(p, spec)
    with torch.no_grad():
        got = cuda_vit.fused_tokens(torch.from_numpy(t), vit.fused_weights(),
                                    spec.num_heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-5, rtol=1e-4)


_BF16_JAX = """
import sys
import numpy as np, jax, jax.numpy as jnp
from tests.test_torch_port_fused_vit import _mk
from cfen_vit_tpu.ops import pallas_vit as pv
pv._INTERPRET = True
spec, p, t = _mk(np.random.RandomState(0), 3)
pb = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
ref = pv.fused_vit_tokens(pb, spec, jnp.asarray(t, jnp.bfloat16))
assert ref.dtype == jnp.bfloat16
np.save(sys.argv[1], np.asarray(ref, np.float32))
"""


def test_twin_bf16_matches_jax_pallas_kernel(tmp_path):
    """The Pallas kernel runs in a fresh interpreter with XLA's
    --xla_allow_excess_precision=false: by default XLA on the CPU keeps
    bf16 intermediates in float32, which skips the kernel's own rounding
    points (ROADMAP Queue C)."""
    out = tmp_path / "ref.npy"
    res = subprocess.run(
        [sys.executable, "-c", _BF16_JAX, str(out)], cwd=REPO,
        env=dict(os.environ, PYTHONPATH="", JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_allow_excess_precision=false"),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    ref = np.load(out)
    spec, p, t = _mk(np.random.RandomState(0), 3)
    vit = _port_vit(p, spec).to(torch.bfloat16)
    with torch.no_grad():
        got = cuda_vit.fused_tokens(torch.from_numpy(t).bfloat16(),
                                    vit.fused_weights(), spec.num_heads)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, atol=2e-2, rtol=1e-2)


def test_tokens_with_the_switch_on_match_jax_plain(rng, k2_on, twin_calls):
    spec, p, t = _mk(rng, 4)
    ref = vit_tokens_apply(p, spec, jnp.asarray(t), allow_pallas=False)
    with torch.no_grad():
        got = _port_vit(p, spec).tokens(torch.from_numpy(t))
    assert twin_calls == [t.shape]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4)


def test_switch_off_by_default_takes_the_unfused_path(rng, monkeypatch, twin_calls):
    monkeypatch.delenv("CFEN_PALLAS_VIT", raising=False)
    monkeypatch.setenv("CFEN_PALLAS_VIT_MIN_E", "0")
    spec, p, t = _mk(rng, 2)
    assert not cuda_vit.use_fused_vit() and cuda_vit.supported(spec)
    with torch.no_grad():
        _port_vit(p, spec).tokens(torch.from_numpy(t))
    assert twin_calls == []


def test_supported_matrix(monkeypatch):
    """tests/test_pallas_vit.py test_supported_matrix, case for case, and
    the port's answer equals JAX's on each."""
    monkeypatch.delenv("CFEN_PALLAS_VIT_MIN_E", raising=False)
    base = dict(img_dim=32, patch_dim=2, num_channels=24, embedding_dim=96,
                num_heads=4, num_layers=1, hidden_dim=384)
    cases = [({}, False),
             (dict(num_channels=96, embedding_dim=384, hidden_dim=1536), True),
             (dict(img_dim=16, patch_dim=4, embedding_dim=1536, hidden_dim=6144), False),
             (dict(no_norm=True), False), (dict(no_mlp=True), False),
             (dict(pos_every=True), False), (dict(no_pos=True), False),
             (dict(num_layers=2, embedding_dim=384, hidden_dim=1536), False),
             # GViT L2 of the canonical model: over the 9 MB budget
             (dict(img_dim=16, patch_dim=4, num_channels=48, embedding_dim=768,
                   hidden_dim=3072), False)]
    for kw, want in cases:
        spec = JaxViTSpec(**{**base, **kw})
        port_spec = TV.ViTSpec(**dataclasses.asdict(spec))
        assert pv.supported(None, spec) == want, kw
        assert cuda_vit.supported(port_spec) == want, kw
    monkeypatch.setenv("CFEN_PALLAS_VIT_MIN_E", "0")
    small = TV.ViTSpec(**base)
    assert cuda_vit.supported(small) and pv.supported(None, JaxViTSpec(**base))


def test_tokens_reference_is_the_unfused_token_pipeline(rng, monkeypatch):
    monkeypatch.delenv("CFEN_PALLAS_VIT", raising=False)
    spec, p, t = _mk(rng, 3)
    vit = _port_vit(p, spec)
    x = torch.from_numpy(t)
    with torch.no_grad():
        torch.testing.assert_close(
            cuda_vit.tokens_reference(x, vit.fused_weights(), spec.num_heads),
            vit.tokens(x), rtol=0, atol=1e-6)


def test_autograd_function_recomputes_through_the_reference(rng, monkeypatch):
    """The Function's forward (its launch swapped for the twin, since the
    kernel needs a card) and its backward, a recompute through
    tokens_reference, against plain autograd of tokens_reference."""
    spec, p, t = _mk(rng, 2)
    monkeypatch.setattr(cuda_vit, "_launch", cuda_vit.fused_tokens_plain)
    weights = [w.detach() for w in _port_vit(p, spec).fused_weights()]
    cot = torch.from_numpy(rng.randn(*t.shape).astype(np.float32))

    def grads(fn):
        leaves = [torch.from_numpy(t).requires_grad_()] + [
            w.clone().requires_grad_() for w in weights]
        out = fn(leaves[0], leaves[1:])
        return out, torch.autograd.grad(out, leaves, cot)

    before = cuda_vit.recomputes
    out, got = grads(lambda x, w: cuda_vit._FusedTokens.apply(spec.num_heads, x, *w))
    assert cuda_vit.recomputes == before + 1
    ref, want = grads(lambda x, w: cuda_vit.tokens_reference(x, w, spec.num_heads))
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=5e-5)
    for name, a, b in zip(("t",) + cuda_vit.FUSED_WEIGHTS, got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * b.abs().max().item(),
                                   msg=name)


def test_wrapper_runs_the_twin_on_cpu_without_launching(rng):
    spec, p, t = _mk(rng, 2)
    w = _port_vit(p, spec).fused_weights()
    before = cuda_vit.launches
    x = torch.from_numpy(t)
    with torch.no_grad():
        torch.testing.assert_close(cuda_vit.fused_tokens(x, w, spec.num_heads),
                                   cuda_vit.fused_tokens_plain(x, w, spec.num_heads),
                                   rtol=0, atol=0)
    assert cuda_vit.launches == before


# the smallest v3 geometry whose LViT blocks (S 64) and level-1 GViT
# (S 64) reach K2: load 128, 16 px tiles, 256 px input
K2_TINY = dict(n_feats=8, load_size=128, patch_size=16, num_heads=2,
               hidden_dim_ratio=2)


def test_generator_with_the_switch_on_matches_jax_plain(k2_on, twin_calls):
    """With CFEN_PALLAS_VIT_MIN_E=0 every LViT block and each level-1 GViT
    goes through K2's twin: 4 per decoder branch and 4 in the encoder.
    One forward on each side, the ActNorm init pass, from the port's seeded
    init carried into JAX by its .pth importer (JAX's generator_init alone
    takes half a minute on the CPU at this size)."""
    spec = replace(JR.generator_spec("iid_hlgvit_crs_gd4_cfs_v3"), **K2_TINY)
    tspec = replace(TR.generator_spec("iid_hlgvit_crs_gd4_cfs_v3"), **K2_TINY)
    net = init_weights(Generator(tspec), torch.Generator().manual_seed(11)).eval()
    params = import_generator_state_dict(net.state_dict(), spec)
    x = np.random.RandomState(2).uniform(-1, 1, (1, 256, 256, 3)).astype(np.float32)
    ref, _ = jax.jit(lambda p, xx: JG.generator_forward(
        p, spec, xx, actnorm_init=True))(params, jnp.asarray(x))
    with torch.no_grad():
        out = net(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    assert len(twin_calls) == 16
    for b in "rsd":
        got = out[b].numpy().transpose(0, 2, 3, 1)
        assert np.abs(got - np.asarray(ref[b])).max() < 2e-4, b
