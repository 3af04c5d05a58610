"""The port's v3 generator (cfen_vit_tpu_torch/models/generator.py) against
the JAX package's plain path, weight for weight, at the repository's tiny
test geometry (tests/ref_utils.py tiny_opt: n_feats 8, loadSize 64,
patch 8, 2 heads, hidden ratio 2, 128 px input).  JAX weights come from generator_init and its ActNorm init
pass, and cross through interop/from_jax.py.  Bar: < 2e-4 in float32 on
every branch (the JAX package's own golden bar).
"""

import dataclasses
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cfen_vit_tpu.interop.torch_export import export_generator_state_dict
from cfen_vit_tpu.models import generator as JG
from cfen_vit_tpu.models import registry as JR
from cfen_vit_tpu_torch.interop.from_jax import state_dict_from_jax
from cfen_vit_tpu_torch.interop.torch_import import (live_state_dict,
                                                     load_reference_state_dict)
from cfen_vit_tpu_torch.models import registry as TR
from cfen_vit_tpu_torch.models.generator import Generator

V3 = "iid_hlgvit_crs_gd4_cfs_v3"
TINY = dict(n_feats=8, load_size=64, patch_size=8, num_heads=2, hidden_dim_ratio=2)
BAR = 2e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def ref():
    """One JAX run shared by the module: params before and after the ActNorm
    init pass on x0, and the outputs of both passes."""
    spec = replace(JR.generator_spec(V3), **TINY)
    p0 = JG.generator_init(jax.random.PRNGKey(7), spec)
    rng = np.random.RandomState(0)
    x0, x1 = (rng.uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32)
              for _ in range(2))
    out0, p1 = jax.jit(lambda p, x: JG.generator_forward(
        p, spec, x, actnorm_init=True))(p0, jnp.asarray(x0))
    out1 = jax.jit(lambda p, x: JG.generator_forward(p, spec, x))(p1, jnp.asarray(x1))
    return SimpleNamespace(
        spec=spec, tspec=replace(TR.generator_spec(V3), **TINY),
        p0=_np_tree(p0), p1=_np_tree(p1), x0=x0, x1=x1,
        out0=_np_tree(out0), out1=_np_tree(out1))


@pytest.fixture(scope="module")
def net(ref):
    g = Generator(ref.tspec).eval()
    g.load_state_dict(state_dict_from_jax(ref.p1, ref.tspec), strict=True)
    return g


def _assert_branches(out, ref_out, branches):
    assert sorted(out) == sorted(branches)
    for b in branches:
        got = out[b].numpy().transpose(0, 2, 3, 1)
        assert got.shape == ref_out[b].shape
        diff = np.abs(got - ref_out[b]).max()
        assert diff < BAR, f"branch {b}: {diff}"


def test_from_jax_equals_the_exporter_on_every_live_key(ref):
    sd = state_dict_from_jax(ref.p1, ref.tspec)
    exported = live_state_dict(export_generator_state_dict(ref.p1, ref.spec))
    assert set(sd) == set(exported)
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(exported[k]), err_msg=k)
    assert set(Generator(ref.tspec).state_dict()) == set(sd)


def test_all_branches_match_jax(ref, net):
    with torch.no_grad():
        out = net(_nchw(ref.x1))
    _assert_branches(out, ref.out1, "rsd")


def test_d_only_matches_jax_and_skips_rs_level1_and_tails(ref, net):
    calls = []
    skipped = ["lgcat_conv_d01r", "globalvit_decoder_01s", "sk_conv_d02r",
               "sk_conv_d02s", "us_conv_d01r", "us_conv_d01s"]
    ran = ["lgcat_conv_d02r", "us_conv_d02s", "lgcat_conv_d01d", "us_conv_d01d"]
    handles = [getattr(net, name).register_forward_hook(
        lambda m, i, o, _n=name: calls.append(_n)) for name in skipped + ran]
    handles += [getattr(net, t)[0][1].register_forward_hook(
        lambda m, i, o, _n=t: calls.append(_n)) for t in ("tail_R", "tail_S")]
    try:
        with torch.no_grad():
            out = net(_nchw(ref.x1), branches="d")
    finally:
        for h in handles:
            h.remove()
    _assert_branches(out, ref.out1, "d")
    assert set(calls) == set(ran)


def test_actnorm_init_pass_matches_jax(ref):
    """Uninitialised ActNorms take their statistics from the first batch, in
    forward order, as the JAX ANCtx pass does."""
    g = Generator(ref.tspec).eval()
    g.load_state_dict(state_dict_from_jax(ref.p0, ref.tspec), strict=True)
    assert all(int(v) == 0 for k, v in g.state_dict().items()
               if k.endswith("initialized"))
    with torch.no_grad():
        out = g(_nchw(ref.x0))
    _assert_branches(out, ref.out0, "rsd")
    want = state_dict_from_jax(ref.p1, ref.tspec)
    got = g.state_dict()
    n_an = 0
    for k in want:
        if k.endswith("initialized"):
            n_an += 1
            assert int(got[k]) == 1, k
            base = k[: -len("initialized")]
            for part in ("weight", "bias"):
                np.testing.assert_allclose(got[base + part].numpy(),
                                           want[base + part].numpy(),
                                           atol=BAR, err_msg=base + part)
    assert n_an == 24


def test_local_vit_tiling_matches_jax(ref, net, rng):
    x = rng.randn(2, 64, 64, 8).astype(np.float32)
    jref = JG._local_vit(ref.p1["lvit_e01"], ref.spec, 1, jnp.asarray(x),
                         JG.ANCtx(False), ("lvit_e01",))
    with torch.no_grad():
        got = net._local_vit(net.localvit_encoder_01, _nchw(x))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(jref),
                               atol=2e-5)


def test_reference_checkpoint_loads_strict_without_dead_tensors(ref):
    """A reference-format state_dict (the exporter's, dead tensors included,
    saved under DataParallel's module. prefix) loads strict."""
    sd = {f"module.{k}": torch.tensor(np.ascontiguousarray(v))
          for k, v in export_generator_state_dict(ref.p1, ref.spec).items()}
    assert any(".decoder." in k for k in sd) and "module.sub_mean.weight" in sd
    g = Generator(ref.tspec).eval()
    load_reference_state_dict(g, sd)
    with torch.no_grad():
        out = g(_nchw(ref.x1), branches="d")
    _assert_branches(out, ref.out1, "d")
    sd["module.tail_D.0.9.weight"] = torch.zeros(1)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_reference_state_dict(Generator(ref.tspec), sd)


@pytest.mark.parametrize("name", sorted(JR._REGISTRY))
def test_registry_matches_jax(name):
    cfg = SimpleNamespace(n_feats=16, n_colors=3, patch_size=16, patch_dim=2,
                          num_heads=4, num_layers=2, hidden_dim_ratio=3,
                          loadSize=128, no_norm=True, no_mlp=False,
                          pos_every=True, no_pos=False, l2g_ratio=2)
    assert (dataclasses.asdict(TR.generator_spec(name, cfg))
            == dataclasses.asdict(JR.generator_spec(name, cfg)))
