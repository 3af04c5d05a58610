"""The port's inference CLI (python -m cfen_vit_tpu_torch.test) against the
repository's JAX test.py on one reference-format .pth, at the tiny
geometry, on the CPU (--gpu_ids -1).  Bar: PNGs within 2/255 per pixel
(the JAX package's own .pth CLI bar).  The port runs in a subprocess
with PYTHONPATH cleared, so nothing imports jax for it, and must not
import jax itself."""

import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from tests.ref_utils import load_repo_module

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_FLAGS = ["--model", "dec_vit", "--dataset_mode", "dec_vit",
              "--model_G", "iid_hlgvit_crs_gd4_cfs_v3", "--n_feats", "8",
              "--loadSize", "64", "--patch_size", "8", "--num_heads", "2",
              "--hidden_dim_ratio", "2", "--sb", "--batchSize", "2"]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """3 seeded hazy PNGs and a reference-format 5_net_G.pth (the JAX
    exporter's state_dict, dead tensors included, after the ActNorm init
    pass)."""
    from dataclasses import replace
    from cfen_vit_tpu.interop.torch_export import export_generator_state_dict
    from cfen_vit_tpu.models.generator import generator_forward, generator_init
    from cfen_vit_tpu.models.registry import generator_spec

    tmp = tmp_path_factory.mktemp("port_cli")
    rng = np.random.RandomState(0)
    (tmp / "data" / "hazy").mkdir(parents=True)
    for i in range(3):
        Image.fromarray((rng.rand(128, 128, 3) * 255).astype(np.uint8)).save(
            tmp / "data" / "hazy" / f"h_{i}.png")
    spec = replace(generator_spec("iid_hlgvit_crs_gd4_cfs_v3"), n_feats=8,
                   load_size=64, patch_size=8, num_heads=2, hidden_dim_ratio=2)
    params = generator_init(jax.random.PRNGKey(5), spec)
    x = jnp.asarray(rng.uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32))
    _, params = jax.jit(lambda p, xx: generator_forward(
        p, spec, xx, actnorm_init=True))(params, x)
    (tmp / "ckpt" / "exp").mkdir(parents=True)
    sd = {k: torch.tensor(np.ascontiguousarray(v)) for k, v in
          export_generator_state_dict(jax.tree_util.tree_map(np.asarray, params),
                                      spec).items()}
    torch.save(sd, tmp / "ckpt" / "exp" / "5_net_G.pth")
    return tmp


def _argv(tmp, results, *extra):
    return ["--dataroot", str(tmp / "data"), "--name", "exp",
            "--checkpoints_dir", str(tmp / "ckpt"),
            "--results_dir", str(tmp / results), "--which_epoch", "5",
            *TINY_FLAGS, *extra]


def _pngs(tmp, results):
    d = tmp / results / "exp" / "test_5" / "images"
    return {f: np.asarray(Image.open(d / f), dtype=np.float32)
            for f in sorted(os.listdir(d))}


def test_port_cli_matches_jax_cli_and_imports_no_jax(env):
    load_repo_module("test").main(_argv(env, "res_jax", "--out_all"))
    script = textwrap.dedent(f"""
        import sys
        from cfen_vit_tpu_torch.test import main
        main({_argv(env, "res_port", "--out_all", "--gpu_ids", "-1")!r})
        assert "jax" not in sys.modules, "the port imported jax"
        """)
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=""),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    jax_out, port_out = _pngs(env, "res_jax"), _pngs(env, "res_port")
    assert sorted(port_out) == [f"h_{i}_fake_A.png" for i in range(3)]
    assert sorted(jax_out) == sorted(port_out)
    for name, img in port_out.items():
        assert img.shape == (128, 128, 3)
        assert np.abs(img - jax_out[name]).max() <= 2.0, name
    assert os.path.exists(env / "res_port" / "exp" / "test_5" / "index.html")


def test_port_cli_all_branches_match_jax_cli(env):
    from cfen_vit_tpu_torch.test import main
    load_repo_module("test").main(_argv(env, "res_jax_all"))
    stats = main(_argv(env, "res_port_all", "--gpu_ids", "-1"))
    assert stats["images"] == 3 and stats["device"] == "cpu"
    jax_out, port_out = _pngs(env, "res_jax_all"), _pngs(env, "res_port_all")
    assert sorted(port_out) == sorted(jax_out)
    assert {n.split("_", 2)[-1] for n in port_out} == {
        "fake_A.png", "fake_R.png", "fake_S.png", "real_B.png"}
    for name, img in port_out.items():
        assert np.abs(img - jax_out[name]).max() <= 2.0, name


def test_gpu_ids_0_raises_without_cuda(env, monkeypatch):
    from cfen_vit_tpu_torch.test import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(_argv(env, "res_gpu", "--gpu_ids", "0"))


def test_select_device():
    from cfen_vit_tpu_torch.config import select_device
    assert select_device("-1") == torch.device("cpu")
    with pytest.raises(ValueError, match="one card"):
        select_device("0,1")


def test_checkpoint_resolution(tmp_path):
    from cfen_vit_tpu_torch.train.checkpoint import latest_epoch, load_net
    cfg = SimpleNamespace(checkpoints_dir=str(tmp_path), name="exp")
    assert latest_epoch(cfg) is None
    (tmp_path / "exp").mkdir()
    for f in ("3_net_G.pth", "12_net_G.msgpack", "latest_net_G.pth", "7_net_D.pth"):
        (tmp_path / "exp" / f).write_bytes(b"")
    assert latest_epoch(cfg) == "12"
    with pytest.raises(ValueError, match="msgpack"):   # an empty file
        load_net(cfg, "12", "G", torch.nn.Module())
    with pytest.raises(FileNotFoundError):
        load_net(cfg, "4", "G", torch.nn.Module())
