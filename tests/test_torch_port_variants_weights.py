"""Reference weight names of every `--model_G` spec in the port: the
port's state_dict read back by the JAX package's `.pth` importer
(interop/torch_import.py) gives the tree the weights started from, and a
reference-format dict with each family's dead tensors loads strict
(cfen_vit_tpu_torch/interop/torch_import.py).

The one gap is the JAX importer's: it reads no ActNorm of iid_cnn_crs's
ds_conv_e0{2,3} (torch_import.py:140-142), which its generator_init
creates (generator.py:248) and the port owns (ROADMAP Queue C)."""

import functools

import numpy as np
import pytest
import torch

import jax

from cfen_vit_tpu.interop.torch_export import _dead_decoder, _meanshift
from cfen_vit_tpu.interop.torch_import import import_generator_state_dict
from cfen_vit_tpu.models import generator as JG
from cfen_vit_tpu.models import registry as JR
from cfen_vit_tpu_torch.interop.from_jax import state_dict_from_jax
from cfen_vit_tpu_torch.interop.torch_import import load_reference_state_dict
from cfen_vit_tpu_torch.models.generator import Generator
from cfen_vit_tpu_torch.models.vit import ViT
from tests import torch_variant_cases as C
from tests.torch_variant_cases import release_file_memory  # noqa: F401

NAMES = sorted(JR._REGISTRY)


@functools.lru_cache(maxsize=None)
def _random_tree(name):
    """generator_init's tree of `name` (its structure and shapes, traced
    without running) filled from a seed, ActNorms marked initialised, so a
    swapped or mistransposed tensor shows."""
    spec, tspec = C.specs(name)
    shapes = jax.eval_shape(lambda k: JG.generator_init(k, spec),
                            jax.random.PRNGKey(1))
    rng = np.random.RandomState(2)

    def redraw(path, a):
        if path[-1].key == "initialized":
            return np.ones(a.shape, a.dtype)
        return rng.randn(*a.shape).astype(a.dtype)
    return spec, tspec, jax.tree_util.tree_map_with_path(redraw, shapes)


def _importer_gaps(spec, tree):
    """The tree less what the JAX importer does not read."""
    tree = dict(tree)
    if spec.ds_norm == "actnorm":
        for lvl in (2, 3):
            tree[f"ds_e0{lvl}"] = {"conv": tree[f"ds_e0{lvl}"]["conv"]}
    return tree


def _dead_tensors(net):
    """What a reference checkpoint of `net`'s family stores and never
    uses: the MeanShift pair and, in every ViT block, the decoder,
    query_embed and position_ids (JAX interop/torch_export.py)."""
    sd = {}
    _meanshift(sd, "sub_mean", sign=-1)
    _meanshift(sd, "add_mean", sign=1)
    for prefix, m in net.named_modules():
        if isinstance(m, ViT):
            vs = m.spec
            _dead_decoder(sd, prefix, vs.embedding_dim, vs.hidden_dim)
            if not vs.no_mlp:
                sd[f"{prefix}.query_embed.weight"] = np.zeros(
                    (1, vs.embedding_dim * vs.seq_length), np.float32)
            if not vs.no_pos:
                sd[f"{prefix}.position_encoding.position_ids"] = np.arange(
                    vs.seq_length, dtype=np.int64)[None]
    return {k: torch.tensor(v) for k, v in sd.items()}


@pytest.mark.parametrize("name", NAMES)
def test_jax_importer_reads_the_ports_state_dict_back(name):
    spec, tspec, tree = _random_tree(name)
    net = Generator(tspec)
    net.load_state_dict(state_dict_from_jax(tree, tspec), strict=True)
    sd = net.state_dict()
    back = import_generator_state_dict(sd, spec)
    want = _importer_gaps(spec, tree)
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert set(flat_back) == set(flat_want)
    for path, v in flat_want.items():
        np.testing.assert_array_equal(np.asarray(flat_back[path]), v,
                                      err_msg=jax.tree_util.keystr(path))
    if spec.ds_norm == "actnorm":   # the gap: the port owns what JAX drops
        assert {"ds_conv_e02.1.weight", "ds_conv_e03.1.bias"} <= set(sd)


@pytest.mark.parametrize("name", NAMES)
def test_reference_pth_with_dead_tensors_loads_strict(name):
    _, tspec, tree = _random_tree(name)
    src = Generator(tspec)
    src.load_state_dict(state_dict_from_jax(tree, tspec), strict=True)
    ref = {**src.state_dict(), **_dead_tensors(src)}
    ref = {f"module.{k}": v for k, v in ref.items()}   # DataParallel's save
    assert len(ref) > len(src.state_dict())
    net = Generator(tspec)
    load_reference_state_dict(net, ref)
    got = net.state_dict()
    for k, v in src.state_dict().items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    ref["module.tail_unknown.0.1.weight"] = torch.zeros(1)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_reference_state_dict(Generator(tspec), ref)
