"""The port's GAN training step (cfen_vit_tpu_torch/train/) against the JAX
package's GanTrainer, at the tiny geometry of tests/test_train.py (n_feats
8, loadSize 64, patch 8, 2 heads, 128 px, batch 2, pool 4), on the CPU:
one JAX step (remat on, as the CLI runs it) and the port's from the same
weights, at the bars of tests/torch_train_cases.py, which holds the step
and the checks; then the port alone (skip gate, pool, schedule, resume,
the CLIs).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from cfen_vit_tpu import config as jax_config
from cfen_vit_tpu_torch import config as port_config
from tests import torch_train_cases as C
from tests.torch_variant_cases import release_file_memory  # noqa: F401

TINY_FLAGS = ["--model", "dec_vit", "--dataset_mode", "dec_vit",
              "--model_G", "iid_hlgvit_crs_gd4_cfs_v3", "--n_feats", "8",
              "--loadSize", "64", "--patch_size", "8", "--num_heads", "2",
              "--hidden_dim_ratio", "2", "--sb", "--batchSize", "2",
              "--pool_size", "4"]


@pytest.fixture(scope="module")
def step(tmp_path_factory):
    """One JAX GanTrainer step and the port's, from the same weights."""
    return C.step(tmp_path_factory.mktemp("port_train"))


def test_train_step_losses_match_jax(step):
    C.check_losses(step)


def test_train_step_grads_match_jax(step):
    C.check_grads(step)


def test_train_step_params_match_jax(step):
    C.check_params(step)


# --------------------------------------------------------------------------
# the port alone: skip gate, pool, schedule, resume, CLIs
# --------------------------------------------------------------------------

def _snapshot(tr):
    def opt_state(opt):
        return [{k: v.clone() for k, v in s.items()} for s in opt.state.values()]
    return {"g": {k: v.clone() for k, v in tr.g.state_dict().items()},
            "d": {k: v.clone() for k, v in tr.d.state_dict().items()},
            "g_opt": opt_state(tr.g_opt), "d_opt": opt_state(tr.d_opt),
            "pools": {k: (p["buf"].clone(), p["n"]) for k, p in tr.pools.items()},
            "step": tr.step}


def _assert_same(a, b):
    assert a["step"] == b["step"]
    for key in ("g", "d"):
        for k in a[key]:
            assert torch.equal(a[key][k], b[key][k]), (key, k)
    for key in ("g_opt", "d_opt"):
        for sa, sb in zip(a[key], b[key]):
            for k in sa:
                assert torch.equal(sa[k], sb[k]), (key, k)
    for k in a["pools"]:
        assert torch.equal(a["pools"][k][0], b["pools"][k][0])
        assert a["pools"][k][1] == b["pools"][k][1]


@pytest.mark.parametrize("bad", ["nan", "-inf", "threshold"])
def test_skip_gate_leaves_the_state_unchanged(tmp_path, monkeypatch, bad):
    """A skipped step leaves params, Adam moments and step counts, the
    trainer's step and the pools exactly as they were; the gate reads the
    G loss only (JAX trainer.py:446)."""
    from cfen_vit_tpu_torch.train import trainer as T
    cfg = C.cfg(port_config, tmp_path, n_feats=8,
               skip_threshold=-1.0 if bad == "threshold" else 1e8)
    tr = T.GanTrainer(cfg, torch.device("cpu"))
    tr.set_input(C.u8_batch(1))
    tr.optimize_parameters(cfg)                   # a healthy step
    snap = _snapshot(tr)
    if bad == "nan":
        b = C.u8_batch(2)
        b["B"] = b["B"] + np.float32("nan")
        tr.set_input(b)
    else:
        tr.set_input(C.u8_batch(2))
        if bad == "-inf":                         # (1 - ssim) * 3 = -inf
            monkeypatch.setattr(T, "ssim", lambda a, b: torch.tensor(float("inf")))
    tr.optimize_parameters(cfg)
    g = tr.get_current_losses()["G"]
    assert {"nan": np.isnan(g), "-inf": g == -np.inf, "threshold": np.isfinite(g)}[bad]
    _assert_same(snap, _snapshot(tr))


def test_image_pool_semantics():
    """Below capacity the pool stores and returns the input; at capacity
    each output is the input or an entry swapped out of the buffer."""
    from cfen_vit_tpu_torch.train.trainer import pool_init, pool_query
    rng = np.random.RandomState(0)
    gen = torch.Generator().manual_seed(0)
    imgs = torch.tensor(rng.randn(3, 1, 4, 4).astype(np.float32))
    pool = pool_init(4, (1, 4, 4))
    pool, out = pool_query(pool, imgs, gen)
    torch.testing.assert_close(out, imgs)
    assert pool["n"] == 3
    torch.testing.assert_close(pool["buf"][:3], imgs)
    pool, _ = pool_query(pool, torch.tensor(rng.randn(3, 1, 4, 4).astype(np.float32)), gen)
    assert pool["n"] == 4
    buf_before = pool["buf"][:4].clone()
    probe = torch.tensor(rng.randn(8, 1, 4, 4).astype(np.float32))
    pool, out = pool_query(pool, probe, gen)
    swapped = 0
    for i in range(8):
        candidates = [probe[i]] + list(buf_before) + list(probe[:i])
        assert any(torch.equal(out[i], c) for c in candidates)
        swapped += not torch.equal(out[i], probe[i])
    assert 0 < swapped < 8
    assert pool_init(0, (1, 4, 4))["buf"].shape[0] == 0


@pytest.mark.parametrize("policy,epochs", [("lambda", (0, 1, 98, 99, 150, 299)),
                                           ("step", (0, 199, 200, 450))])
def test_lr_for_epoch_matches_jax(policy, epochs):
    from cfen_vit_tpu.train.schedule import lr_for_epoch as jax_lr
    from cfen_vit_tpu_torch.train.schedule import lr_for_epoch
    for count in (1, 5):
        kw = dict(lr=2e-4, niter=100, niter_decay=200, epoch_count=count,
                  lr_policy=policy, lr_decay_iters=200)
        for e in epochs:
            assert lr_for_epoch(port_config.Config(**kw), e) == jax_lr(
                jax_config.Config(**kw), e)


def test_resume_continues_exactly(tmp_path):
    """Save after step 1, resume in a new trainer: step 2 equals the
    uninterrupted step 2 (pools are not saved; their query result is
    discarded, so they do not reach the losses or the params)."""
    from cfen_vit_tpu_torch.train.trainer import GanTrainer
    cfg = C.cfg(port_config, tmp_path, name="run")
    tr = GanTrainer(cfg, torch.device("cpu"))
    tr.set_input(C.u8_batch(3))
    tr.optimize_parameters(cfg)
    tr.save_networks("1")
    tr.set_input(C.u8_batch(4))
    tr.optimize_parameters(cfg)

    cfg2 = dataclasses.replace(cfg, continue_train=True, which_epoch="1", seed=99)
    tr2 = GanTrainer(cfg2, torch.device("cpu"))
    tr2.setup(cfg2)
    assert tr2.step == 1
    tr2.set_input(C.u8_batch(4))
    tr2.optimize_parameters(cfg2)
    assert tr2.get_current_losses() == tr.get_current_losses()
    a, b = _snapshot(tr), _snapshot(tr2)
    a["pools"] = b["pools"] = {}
    _assert_same(a, b)


def _write_quadruples(root, n=4, size=128):
    from PIL import Image
    rng = np.random.RandomState(5)
    for d in ("hazy", "clear", "r", "s"):
        (root / d).mkdir(parents=True)
        for i in range(n):
            Image.fromarray((rng.rand(size, size, 3) * 255).astype(np.uint8)).save(
                root / d / f"im_{i}.png")


def test_train_cli_then_test_cli_on_the_cpu(tmp_path):
    """Two steps of `python -m cfen_vit_tpu_torch.train` on the CPU, then
    the test CLI reads the generator it wrote."""
    from cfen_vit_tpu_torch.test import main as test_main
    from cfen_vit_tpu_torch.train.cli import main as train_main
    _write_quadruples(tmp_path / "data")
    common = ["--dataroot", str(tmp_path / "data"), "--name", "exp",
              "--checkpoints_dir", str(tmp_path / "ckpt"), *TINY_FLAGS,
              "--gpu_ids", "-1"]
    log = train_main(common + ["--niter", "1", "--niter_decay", "0",
                               "--print_freq", "2", "--display_freq", "2"])
    assert len(log["losses"]) == 2 and log["model"].step == 2
    assert all(np.isfinite(v) for losses in log["losses"] for v in losses.values())
    ckpt = tmp_path / "ckpt" / "exp"
    for f in ("1_net_G.pth", "latest_net_G.pth", "1_net_D_A.pth", "1_net_D_R.pth",
              "1_net_D_S.pth", "1_train_state.pt", "loss_log.txt"):
        assert (ckpt / f).exists(), f
    assert any(f.endswith("fake_A.png") for f in os.listdir(ckpt / "web" / "images"))
    stats = test_main(common + ["--results_dir", str(tmp_path / "res"),
                                "--which_epoch", "1", "--out_all"])
    assert stats["images"] == 4
    assert len(os.listdir(tmp_path / "res" / "exp" / "test_1" / "images")) == 4


def test_trace_dir_raises(tmp_path):
    """--trace_dir is ported (tests/test_torch_port_profiling.py holds its
    steps 10-15); what raises now is a second trace while one runs, since
    torch.profiler runs one at a time."""
    from cfen_vit_tpu_torch.utils.profiling import start_trace, stop_trace, tracing
    start_trace(str(tmp_path / "a"))
    try:
        with pytest.raises(RuntimeError, match="already running"):
            start_trace(str(tmp_path / "b"))
    finally:
        stop_trace()
    assert not tracing() and (tmp_path / "a" / "trace.json").exists()
