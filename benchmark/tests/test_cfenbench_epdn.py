"""The EPDN cell (loops/epdn_closed.py) at a tiny geometry on the CPU: a
sound run is correct under the cell's own limits, and a run with the
timed path broken underneath is not (the chip check is skipped):

  * a step that leaves the state unchanged;
  * half of each batch left out;
  * the pool answering with the fakes, never with a stored image, in the
    steps after the checked ones (the pool's answer is part of the
    step: the cell's configuration runs none, pix2pixHD's default, so
    the tiny cell turns one on)."""

import copy

import numpy as np
import pytest
import torch

from benchmark.run import Cell, ROOT, load_json, run_cell

CPU = torch.device("cpu")


def tiny_epdn(pool_size: int = 3) -> Cell:
    """The cell with every width cut and 128x128 pairs at batch 2 (at 64
    the global trunk's instance norms see 2x2 maps and float32 is noise
    at the cell's limits); a pool of 3 that the window fills."""
    cell = Cell("epdn_train_b4_fp32", load_json(ROOT / "BENCHMARK.json"))
    cfg = copy.deepcopy(cell.config)
    cfg.update(ngf=4, ngf_global=8, ndf=8, image_side=128, pool_size=pool_size)
    cell.config = cfg
    cell.mix = dict(cell.mix, batch=2, pool_batches=4, trace_steps=2)
    return cell


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("pool_size", [0, 3])
def test_sound_run_is_correct(pool_size):
    out = run_cell(tiny_epdn(pool_size), 2 ** 33 + 1, 0.5, False, CPU)
    assert out["correct"], out["checks"]


def test_state_left_unchanged(monkeypatch):
    from cfen_vit_tpu_torch.train import pix2pixhd as T
    step = T.EpdnTrainer.optimize_parameters

    def frozen(self, cfg=None):
        params = list(self.g.parameters()) + list(self.d.parameters())
        keep = [p.detach().clone() for p in params]
        step(self, cfg)
        with torch.no_grad():
            for p, k in zip(params, keep):
                p.copy_(k)
    monkeypatch.setattr(T.EpdnTrainer, "optimize_parameters", frozen)
    out = run_cell(tiny_epdn(), 2 ** 33 + 2, 0.5, False, CPU)
    dparam3 = out["checks"]["dparam3"]
    assert not out["correct"] and dparam3["value"] > dparam3["limit"]


def test_half_batch_left_out(monkeypatch):
    from cfen_vit_tpu_torch.train import pix2pixhd as T
    set_input = T.EpdnTrainer.set_input

    def half(self, batch):
        set_input(self, {k: v[:len(v) // 2] if isinstance(v, np.ndarray)
                         else v for k, v in batch.items()})
    monkeypatch.setattr(T.EpdnTrainer, "set_input", half)
    assert not run_cell(tiny_epdn(), 2 ** 33 + 3, 0.5, False, CPU)["correct"]


def test_pool_bypassed_after_warm_up(monkeypatch):
    """D trains on the current fakes once the checked steps are done: the
    step after the window, whose pool is full, catches it."""
    from cfen_vit_tpu_torch.train import pix2pixhd as T
    query = T.pool_query
    cell = tiny_epdn()
    calls = [0]

    def bypassed(pool, images, gen):
        calls[0] += 1
        out = query(pool, images, gen)
        return (pool, images) if calls[0] > cell.mix["checked_steps"] else out
    monkeypatch.setattr(T, "pool_query", bypassed)
    out = run_cell(cell, 2 ** 33 + 4, 0.5, False, CPU)
    checks = out["checks"]
    assert not out["correct"], checks
    for early in ("loss1", "fake1", "dparam3"):
        assert checks[early]["value"] <= checks[early]["limit"], early
