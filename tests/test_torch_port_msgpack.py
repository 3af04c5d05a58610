"""The JAX package's msgpack checkpoints read by the port
(cfen_vit_tpu_torch/interop/flax_msgpack.py, train/checkpoint.py
`load_net`).

A checkpoint written by the JAX `save_net` (flax msgpack) must load into
the port bit for bit equal to the interop/from_jax.py bridge of the same
tree: v3 and decr_vit's spec, D_A, a bfloat16 tree and a tree whose
arrays flax writes in chunks.  The port's test CLI on the v3 checkpoint
stays within 2/255 per pixel of the JAX test.py on the same PNGs (the
JAX package's own .pth CLI bar)."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from cfen_vit_tpu.models import discriminator as JD
from cfen_vit_tpu.train import checkpoint as JC
from cfen_vit_tpu_torch.config import parse_args
from cfen_vit_tpu_torch.interop.flax_msgpack import restore
from cfen_vit_tpu_torch.interop.from_jax import (
    discriminator_state_dict_from_jax, state_dict_from_jax)
from cfen_vit_tpu_torch.models import registry as TR
from cfen_vit_tpu_torch.models.discriminator import Discriminator
from cfen_vit_tpu_torch.models.generator import Generator
from cfen_vit_tpu_torch.train.checkpoint import load_net
from tests.ref_utils import load_repo_module
from tests import torch_variant_cases as C
from tests.torch_variant_cases import np_tree
from tests.torch_variant_cases import release_file_memory  # noqa: F401

V3, DECR = "iid_hlgvit_crs_gd4_cfs_v3", "iidr_hlgvit_crs_gd4"
TINY_FLAGS = ["--model", "dec_vit", "--dataset_mode", "dec_vit",
              "--model_G", V3, "--n_feats", "8", "--loadSize", "64",
              "--patch_size", "8", "--num_heads", "2",
              "--hidden_dim_ratio", "2", "--sb", "--batchSize", "2"]


@pytest.fixture(scope="module")
def trees():
    return {name: C.filled_tree(name) for name in (V3, DECR)}


def _cfg(tmp):
    return SimpleNamespace(checkpoints_dir=str(tmp), name="exp")


def _assert_bit_equal(got: dict, want: dict):
    """State dicts equal bit for bit (a bridged dict's 0-d `initialized`
    comes as shape [1], which load_state_dict takes for a 0-d buffer)."""
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        assert torch.equal(got[k], v.reshape(got[k].shape)), k


@pytest.mark.parametrize("case", ["v3", "decr", "v3_bf16", "v3_chunked"])
def test_jax_msgpack_generator_loads_bit_for_bit(case, trees, tmp_path,
                                                 monkeypatch):
    import flax.serialization
    name = DECR if case == "decr" else V3
    _, tspec, tree = trees[name]
    if case == "v3_bf16":
        tree = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.bfloat16)
            if np.issubdtype(np.asarray(a).dtype, np.floating) else a, tree)
    if case == "v3_chunked":   # every array above 4 KiB in chunks of 4 KiB
        monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 4096)
    JC.save_net(_cfg(tmp_path), "5", "G", tree)
    path = tmp_path / "exp" / "5_net_G.msgpack"
    if case == "v3_chunked":
        assert b"__msgpack_chunked_array__" in path.read_bytes()
    net = Generator(tspec)
    load_net(_cfg(tmp_path), "5", "G", net)
    want = state_dict_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
        else np.asarray(a), tree), tspec)
    _assert_bit_equal(net.state_dict(), want)
    if case == "v3_bf16":
        raw = restore(path.read_bytes())
        assert raw["head"]["conv"]["w"].dtype == torch.bfloat16


def test_jax_msgpack_discriminator_loads_bit_for_bit(tmp_path):
    cfg = parse_args(["--gpu_ids", "-1"], save_opt=False)
    tree = np_tree(JD.nlayer_disc_init(jax.random.PRNGKey(3), 6, cfg.ndf, 3))
    JC.save_net(_cfg(tmp_path), "5", "D_A", tree)
    d = Discriminator(cfg)
    load_net(_cfg(tmp_path), "5", "D_A", d)
    _assert_bit_equal(d.state_dict(), discriminator_state_dict_from_jax(tree))


def test_port_test_cli_on_jax_msgpack_matches_jax_cli(trees, tmp_path):
    """JAX save_net's v3 checkpoint through the JAX test.py and the port's
    test CLI (--out_all, on the CPU)."""
    from cfen_vit_tpu_torch.test import main as port_main
    _, _, tree = trees[V3]
    rng = np.random.RandomState(0)
    (tmp_path / "data" / "hazy").mkdir(parents=True)
    for i in range(2):
        Image.fromarray((rng.rand(128, 128, 3) * 255).astype(np.uint8)).save(
            tmp_path / "data" / "hazy" / f"h_{i}.png")
    JC.save_net(SimpleNamespace(checkpoints_dir=str(tmp_path / "ckpt"),
                                name="exp"), "5", "G", tree)

    def argv(results, *extra):
        return ["--dataroot", str(tmp_path / "data"), "--name", "exp",
                "--checkpoints_dir", str(tmp_path / "ckpt"),
                "--results_dir", str(tmp_path / results), "--which_epoch",
                "5", "--out_all", *TINY_FLAGS, *extra]

    load_repo_module("test").main(argv("res_jax"))
    port_main(argv("res_port", "--gpu_ids", "-1"))
    pngs = {}
    for res in ("res_jax", "res_port"):
        d = tmp_path / res / "exp" / "test_5" / "images"
        pngs[res] = {f: np.asarray(Image.open(d / f), dtype=np.float32)
                     for f in sorted(os.listdir(d))}
    assert sorted(pngs["res_port"]) == ["h_0_fake_A.png", "h_1_fake_A.png"]
    assert sorted(pngs["res_jax"]) == sorted(pngs["res_port"])
    for f, img in pngs["res_port"].items():
        assert img.min() < img.max(), f
        assert np.abs(img - pngs["res_jax"][f]).max() <= 2.0, f


def test_continue_train_names_the_missing_train_state(tmp_path):
    from cfen_vit_tpu_torch.train.checkpoint import load_train_state
    (tmp_path / "exp").mkdir()
    (tmp_path / "exp" / "5_train_state.msgpack").write_bytes(b"\x80")
    with pytest.raises(FileNotFoundError,
                       match="5_train_state.pt not found.*JAX package"):
        load_train_state(_cfg(tmp_path), "5")
