"""The port's ViT blocks (cfen_vit_tpu_torch/models/vit.py) against the JAX
package's (cfen_vit_tpu/models/vit.py): same params through the weight
bridge, same seeded inputs, float32 on the CPU, to 2e-5 (summation order
through a few matmuls and LayerNorms)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cfen_vit_tpu.models import vit as JV
from cfen_vit_tpu_torch.interop import from_jax as FJ
from cfen_vit_tpu_torch.models import vit as TV

TOL = 2e-5


def _port_vit(jp, jspec):
    """A port ViT holding the JAX block's weights (strict load)."""
    sd = {}
    FJ._vit(sd, "v", jax.tree_util.tree_map(np.asarray, jp))
    vit = TV.ViT(TV.ViTSpec(**dataclasses.asdict(jspec)))
    vit.load_state_dict({k[2:]: torch.tensor(np.ascontiguousarray(v))
                         for k, v in sd.items()}, strict=True)
    return vit.eval()


def _spec(**kw):
    base = dict(img_dim=8, patch_dim=2, num_channels=8, embedding_dim=32,
                num_heads=2, num_layers=1, hidden_dim=64)
    base.update(kw)
    return JV.ViTSpec(**base)


def test_self_attention_matches_mha_apply(rng):
    p = JV.mha_init(jax.random.PRNGKey(0), 32, 4)
    x = rng.randn(3, 16, 32).astype(np.float32)
    pos = rng.randn(16, 32).astype(np.float32)
    ref = JV.mha_apply(p, jnp.asarray(x + pos), jnp.asarray(x + pos), jnp.asarray(x), 4)
    attn = TV.SelfAttention(32, 4)
    attn.load_state_dict({
        "in_proj_weight": torch.tensor(np.concatenate(
            [np.asarray(p[k]).T for k in ("wq", "wk", "wv")])),
        "out_proj.weight": torch.tensor(np.asarray(p["wo"]).T)}, strict=True)
    with torch.no_grad():
        got = attn(torch.from_numpy(x + pos), torch.from_numpy(x + pos),
                   torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)


@pytest.mark.parametrize("flags", [{}, {"no_norm": True}, {"no_mlp": True},
                                   {"pos_every": True}, {"no_pos": True},
                                   {"num_layers": 2}])
def test_vit_tokens_match_jax(rng, flags):
    spec = _spec(**flags)   # embedding_dim == flatten_dim, as no_mlp needs
    jp = JV.vit_init(jax.random.PRNGKey(1), spec)
    t = rng.randn(4, spec.seq_length, spec.flatten_dim).astype(np.float32)
    ref = JV.vit_tokens_apply(jp, spec, jnp.asarray(t), allow_pallas=False)
    with torch.no_grad():
        got = _port_vit(jp, spec).tokens(torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)


@pytest.mark.parametrize("pools", [0, 2])
def test_vit_apply_on_maps_matches_jax(rng, pools):
    """GViT with two 2x pools and two bilinear upsamples, and a plain ViT."""
    spec = _spec(img_dim=4, patch_dim=2, global_pools=pools)
    jp = JV.vit_init(jax.random.PRNGKey(2), spec)
    side = spec.img_dim << pools
    x = rng.randn(2, side, side, spec.num_channels).astype(np.float32)
    ref = JV.vit_apply(jp, spec, jnp.asarray(x))
    with torch.no_grad():
        got = _port_vit(jp, spec)(torch.from_numpy(
            np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(ref),
                               atol=TOL)


def test_vit_state_dict_keys_are_the_references(rng):
    """Port key names == the JAX exporter's, minus its dead tensors."""
    from cfen_vit_tpu.interop.torch_export import _vit as export_vit
    spec = _spec()
    jp = JV.vit_init(jax.random.PRNGKey(3), spec)
    exported = {}
    export_vit(exported, "v", jp, spec)
    live = {k for k in exported
            if ".decoder." not in k and "query_embed" not in k
            and not k.endswith("position_ids")}
    port = {f"v.{k}" for k in TV.ViT(TV.ViTSpec(**dataclasses.asdict(spec)))
            .state_dict()}
    assert port == live


def test_v5_shrink_is_not_ported():
    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        TV.ViT(TV.ViTSpec(**dataclasses.asdict(_spec(shrink=4))))
