"""The port's own configuration, data loader and image utilities against the
JAX package's, and the rules that keep the port apart from it: no module of
cfen_vit_tpu_torch imports jax, flax, msgpack or anything of cfen_vit_tpu,
and its entry points ask for cuda:0 unless told `--gpu_ids -1`."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from PIL import Image

from cfen_vit_tpu import config as jax_config
from cfen_vit_tpu.data import loader as jax_loader
from cfen_vit_tpu_torch import config as port_config
from cfen_vit_tpu_torch.data import loader as port_loader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--n_feats", "8", "--loadSize", "64", "--patch_size", "8",
        "--num_heads", "2", "--hidden_dim_ratio", "2"]


def test_no_port_module_imports_jax_or_the_jax_package():
    """Every module of the port, imported in a fresh interpreter with
    PYTHONPATH cleared (so nothing preimports jax), leaves neither jax,
    flax, msgpack nor any cfen_vit_tpu module in sys.modules."""
    script = textwrap.dedent("""
        import importlib, pkgutil, sys
        import cfen_vit_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "cfen_vit_tpu_torch.")
                 if not m.name.endswith("__main__")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "flax", "msgpack", "cfen_vit_tpu"))
        print(len(names), bad)
        assert not bad, bad
        """)
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=""), capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[0]) >= 30       # the walk found the package


@pytest.mark.parametrize("is_train", [True, False])
@pytest.mark.parametrize("argv", [
    [],
    ["--name", "exp", "--model", "dec_vit", "--dataset_mode", "dec_vit",
     "--model_G", "iid_hlgvit_crs_gd4_cfs_v3", "--n_feats", "24",
     "--hidden_dim_ratio", "4", "--sb", "--out_all", "--which_epoch", "32",
     "--no_remat", "--compute_dtype", "bfloat16", "--gpu_ids", "-1",
     "--lr", "2e-4", "--suffix", "{model}"],
])
def test_parse_args_gives_the_jax_config(monkeypatch, tmp_path, is_train, argv):
    monkeypatch.setattr(jax_config, "enable_compilation_cache", lambda *a, **k: None)
    argv = argv + ["--checkpoints_dir", str(tmp_path)]
    want = dataclasses.asdict(jax_config.parse_args(argv, is_train=is_train))
    got = dataclasses.asdict(port_config.parse_args(argv, is_train=is_train))
    assert got == want
    assert port_config.Config().gpu_ids == "0"
    assert (port_config.parse_args(argv, is_train, False).input_size()
            == jax_config.parse_args(argv, is_train, False).input_size())


def test_entry_points_ask_for_cuda_by_default(tmp_path, monkeypatch):
    """No --gpu_ids: cuda:0, which raises where torch sees no card."""
    from cfen_vit_tpu_torch.test import main as test_main
    from cfen_vit_tpu_torch.train.cli import main as train_main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "hazy").mkdir()
    common = ["--dataroot", str(tmp_path), "--name", "x",
              "--checkpoints_dir", str(tmp_path / "ck"), *TINY]
    for main in (test_main, train_main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(common)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_config.select_device("0")


def _folder(root, n=5, size=24):
    rng = np.random.RandomState(3)
    for d in ("hazy", "clear", "r", "s"):
        (root / d).mkdir(parents=True)
        for i in range(n):
            Image.fromarray((rng.rand(size, size, 3) * 255).astype(np.uint8)).save(
                root / d / f"im_{i}.png")


@pytest.mark.parametrize("is_train,sb,mode", [(True, True, "dec_vit"),
                                              (False, True, "dec_vit"),
                                              (True, True, "vit"),
                                              (True, False, "dec_vit")])
def test_loader_yields_the_jax_loaders_batches(tmp_path, monkeypatch, is_train, sb, mode):
    """Same folder, same flags: the same batches (B, and in training A, R
    and luma S), paths and partial-batch rule.  The JAX loader's C++ decode
    path is switched off: the port reads PNGs through PIL, as its fallback."""
    from cfen_vit_tpu.data import dataset as jax_dataset
    monkeypatch.setattr(jax_dataset.DecVitDataset, "native_batch",
                        lambda self, idx: None)
    _folder(tmp_path)
    kw = dict(dataroot=str(tmp_path), isTrain=is_train, sb=sb, batchSize=2,
              dataset_mode=mode, seed=4)
    batches = []
    for cfg, mod in ((jax_config.Config(**kw), jax_loader),
                     (port_config.Config(**kw), port_loader)):
        np.random.seed(0)            # the shuffle order when not --sb
        batches.append(list(mod.create_dataloader(cfg).load_data()))
    want, got = batches
    assert len(got) == len(want) == (2 if is_train else 3)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
            else:
                assert g[k] == w[k], k
    if is_train and mode == "dec_vit":
        assert got[0]["S"].shape == (2, 24, 24, 1)


def test_image_utilities_match_jax(tmp_path):
    from cfen_vit_tpu.utils import HTML as JaxHTML, save_images as jax_save
    from cfen_vit_tpu_torch.utils import HTML, save_images, tensor2im
    from cfen_vit_tpu.utils import tensor2im as jax_tensor2im
    rng = np.random.RandomState(6)
    vis = {"fake_A": rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32),
           "fake_S": rng.uniform(-1, 1, (2, 16, 16, 1)).astype(np.float32)}
    for im in (vis["fake_A"][0], vis["fake_S"][0],
               rng.randint(0, 256, (4, 4, 3)).astype(np.uint8)):
        assert np.array_equal(tensor2im(im), jax_tensor2im(im))
    for name, html, save in (("jax", JaxHTML, jax_save), ("port", HTML, save_images)):
        page = html(str(tmp_path / name), "t")
        save(page.get_image_dir(), vis, ["a/x0.png", "a/x1.png"], webpage=page)
        page.save()
    for f in sorted(os.listdir(tmp_path / "jax" / "images")):
        a = np.asarray(Image.open(tmp_path / "jax" / "images" / f))
        b = np.asarray(Image.open(tmp_path / "port" / "images" / f))
        assert np.array_equal(a, b), f
    assert ((tmp_path / "jax" / "index.html").read_text()
            == (tmp_path / "port" / "index.html").read_text())
