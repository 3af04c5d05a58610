"""PyTorch port primitives (cfen_vit_tpu_torch/ops) against the JAX package
(cfen_vit_tpu/ops) on the same seeded numpy inputs, float32 on the CPU.

Maps cross as NHWC (JAX) <-> NCHW (port); weights cross through the weight
bridge's own transposes (interop/from_jax.py), so these tests also hold
the bridge's per-layer layouts.  Tolerance 1e-5: the two sides differ
only in summation order."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cfen_vit_tpu.ops import nn as JN
from cfen_vit_tpu.ops import patch as JP
from cfen_vit_tpu.ops import resize as JR
from cfen_vit_tpu.ops import tiles as JT
from cfen_vit_tpu_torch.interop import from_jax as FJ
from cfen_vit_tpu_torch.ops import nn as TN
from cfen_vit_tpu_torch.ops import patch as TP
from cfen_vit_tpu_torch.ops import resize as TR
from cfen_vit_tpu_torch.ops import tiles as TT

TOL = 1e-5


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _load(module, tensors):
    module.load_state_dict({k: torch.tensor(np.ascontiguousarray(v))
                            for k, v in tensors.items()}, strict=True)
    return module


@pytest.mark.parametrize("k,stride,pad,bias", [(3, 1, 1, True), (3, 2, 1, True),
                                               (5, 1, 2, True), (1, 1, 0, False),
                                               (7, 1, 0, True)])
def test_conv2d_matches_jax(rng, k, stride, pad, bias):
    p = JN.conv_init(jax.random.PRNGKey(1), k, k, 6, 5, bias=bias)
    if bias:
        p["b"] = jnp.asarray(rng.randn(5).astype(np.float32))
    x = rng.randn(2, 16, 16, 6).astype(np.float32)
    ref = JN.conv2d(p, jnp.asarray(x), stride, pad)
    conv = _load(torch.nn.Conv2d(6, 5, k, stride, pad, bias=bias), FJ._conv(p))
    got = conv(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=TOL)


def test_conv_transpose_up2_matches_jax(rng):
    p = JN.conv_transpose_init(jax.random.PRNGKey(2), 4, 4, 6, 3)
    p["b"] = jnp.asarray(rng.randn(3).astype(np.float32))
    x = rng.randn(2, 8, 8, 6).astype(np.float32)
    ref = JN.conv_transpose2d(p, jnp.asarray(x))
    got = _load(TN.conv_transpose_up2(6, 3), FJ._convT(p))(nchw(x))
    assert got.shape == (2, 3, 16, 16)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=TOL)


def test_linear_and_layer_norm_match_jax(rng):
    lp = JN.linear_init(jax.random.PRNGKey(3), 12, 7)
    lp["b"] = jnp.asarray(rng.randn(7).astype(np.float32))
    x = rng.randn(3, 5, 12).astype(np.float32)
    got = _load(torch.nn.Linear(12, 7), FJ._linear(lp))(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(JN.linear(lp, jnp.asarray(x))), atol=TOL)
    g, b = rng.randn(12).astype(np.float32), rng.randn(12).astype(np.float32)
    ln = _load(torch.nn.LayerNorm(12), {"weight": g, "bias": b})
    ref = JN.layer_norm({"g": jnp.asarray(g), "b": jnp.asarray(b)}, jnp.asarray(x))
    np.testing.assert_allclose(ln(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(ref), atol=TOL)


def test_instance_norm_matches_jax(rng):
    x = (rng.randn(2, 16, 12, 5) * 3 + 1).astype(np.float32)
    ref = JN.instance_norm(jnp.asarray(x))
    np.testing.assert_allclose(nhwc(TN.instance_norm(nchw(x))), np.asarray(ref),
                               atol=TOL)


@pytest.mark.parametrize("scale", [0.1, 3.0])
def test_actnorm_init_matches_jax(rng, scale):
    """scale 0.1 puts the variance under the 0.2 floor."""
    x = (rng.randn(2, 9, 7, 6) * scale + 0.5).astype(np.float32)
    y_ref, p_ref = JN.actnorm_apply(JN.actnorm_init(6), jnp.asarray(x), init=True)
    an = TN.ActNorm2d(6)
    with torch.no_grad():
        y = an(nchw(x))
    np.testing.assert_allclose(nhwc(y), np.asarray(y_ref), atol=TOL)
    np.testing.assert_allclose(an.weight.detach().numpy(), np.asarray(p_ref["w"]),
                               atol=TOL)
    np.testing.assert_allclose(an.bias.detach().numpy(), np.asarray(p_ref["b"]),
                               atol=TOL)
    assert int(an.initialized) == 1
    # initialised: a second batch is normalised with the stored parameters
    x2 = rng.randn(1, 4, 4, 6).astype(np.float32)
    with torch.no_grad():
        y2 = an(nchw(x2))
    np.testing.assert_allclose(nhwc(y2), np.asarray(JN.actnorm_apply(
        p_ref, jnp.asarray(x2))), atol=TOL)


def test_actnorm_loaded_state_is_not_reinitialised(rng):
    an = TN.ActNorm2d(3)
    sd = {"weight": torch.tensor([0.1, 0.2, 0.3]), "bias": torch.tensor([1., 2., 3.]),
          "initialized": torch.tensor(1)}
    an.load_state_dict(sd)
    with torch.no_grad():
        an(torch.randn(2, 3, 4, 4))
    torch.testing.assert_close(an.bias.detach(), sd["bias"])


def test_reflection_pad_matches_jax(rng):
    x = rng.randn(2, 8, 9, 3).astype(np.float32)
    got = torch.nn.functional.pad(nchw(x), (3, 3, 3, 3), mode="reflect")
    np.testing.assert_array_equal(nhwc(got), np.asarray(JN.reflection_pad(jnp.asarray(x), 3)))


def test_resize_matches_jax(rng):
    x = rng.randn(2, 8, 12, 5).astype(np.float32)
    np.testing.assert_allclose(nhwc(TR.avg_pool2(nchw(x))),
                               np.asarray(JR.avg_pool2(jnp.asarray(x))), atol=TOL)
    np.testing.assert_allclose(nhwc(TR.upsample_bilinear2(nchw(x))),
                               np.asarray(JR.upsample_bilinear2(jnp.asarray(x))),
                               atol=TOL)


def test_tiles_match_jax(rng):
    x = rng.randn(2, 16, 24, 3).astype(np.float32)
    tiles = TT.split_tiles(nchw(x), 8)
    np.testing.assert_array_equal(nhwc(tiles), np.asarray(JT.split_tiles(jnp.asarray(x), 8)))
    np.testing.assert_array_equal(nhwc(TT.join_tiles(tiles, 2, 16, 24)), x)


def test_patch_tokens_match_jax(rng):
    x = rng.randn(3, 8, 12, 5).astype(np.float32)
    tok = TP.unfold_tokens(nchw(x), 4)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(JP.unfold_tokens(jnp.asarray(x), 4)))
    # the (C, py, px) flatten is torch's own F.unfold layout
    np.testing.assert_array_equal(
        tok.numpy(), torch.nn.functional.unfold(nchw(x), 4, stride=4).transpose(1, 2).numpy())
    np.testing.assert_array_equal(nhwc(TP.fold_tokens(tok, 4, 8, 12)), x)
