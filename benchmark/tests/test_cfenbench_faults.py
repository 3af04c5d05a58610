"""A run with the timed path broken underneath comes out not correct.
The chip check is skipped: the rest of a run (set-up, window, reference,
verdict under the cell's own limits) runs at a tiny geometry on the CPU,
with one fault planted in the port each time:

  * a training step that returns its state unchanged;
  * half of each batch left out, the mean taken over the rest;
  * either of these only in the steps after the checked ones, as a
    change to the timed path after warm-up would be;
  * an answer altered where it is produced (one image of each batch).

The cells run on one chip: there is no exchange between chips to leave
out."""

import numpy as np
import pytest
import torch

from benchmark.run import run_cell
from benchmark.tests.tiny import CPU, tiny_cell

TRAIN = ["v3_train_b4_fp32", "mgvit_train_b4_fp32", "v3_train_b4_bf16"]


def test_unbroken_runs_are_correct():
    for cell in ("v3_infer_b32_bf16", "v3_train_b4_bf16"):
        assert run_cell(tiny_cell(cell), 91, 0.01, False, CPU)["correct"], cell


@pytest.mark.parametrize("cell", TRAIN)
def test_state_left_unchanged(cell, monkeypatch):
    from cfen_vit_tpu_torch.train import trainer as T
    step = T.GanTrainer.optimize_parameters

    def frozen(self, cfg=None):
        keep = [p.detach().clone() for p in
                list(self.g.parameters()) + list(self.d.parameters())]
        step(self, cfg)
        with torch.no_grad():
            for p, k in zip(list(self.g.parameters()) + list(self.d.parameters()),
                            keep):
                p.copy_(k)
    monkeypatch.setattr(T.GanTrainer, "optimize_parameters", frozen)
    out = run_cell(tiny_cell(cell), 92, 0.01, False, CPU)
    assert not out["correct"]
    assert out["checks"]["dparam3"]["value"] > out["checks"]["dparam3"]["limit"]


@pytest.mark.parametrize("cell", TRAIN)
def test_half_batch_left_out(cell, monkeypatch):
    from cfen_vit_tpu_torch.train import trainer as T
    set_input = T.GanTrainer.set_input

    def half(self, batch):
        set_input(self, {k: v[:len(v) // 2] if isinstance(v, np.ndarray) else v
                         for k, v in batch.items()})
    monkeypatch.setattr(T.GanTrainer, "set_input", half)
    out = run_cell(tiny_cell(cell), 93, 0.01, False, CPU)
    assert not out["correct"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("cell", ["v3_train_b4_fp32", "v3_train_b4_bf16"])
def test_fault_after_warm_up(cell, fault, monkeypatch):
    """The checked steps run sound; every step after them has the fault,
    and the step after the window catches it."""
    from cfen_vit_tpu_torch.train import trainer as T
    c = tiny_cell(cell)
    step, set_input = T.GanTrainer.optimize_parameters, T.GanTrainer.set_input
    calls = {"set_input": 0}

    def late_half(self, batch):
        calls["set_input"] += 1
        if calls["set_input"] > c.mix["checked_steps"]:
            batch = {k: v[:len(v) // 2] if isinstance(v, np.ndarray) else v
                     for k, v in batch.items()}
        set_input(self, batch)

    def late_frozen(self, cfg=None):
        params = list(self.g.parameters()) + list(self.d.parameters())
        keep = [p.detach().clone() for p in params]
        steps = self.step
        step(self, cfg)
        if steps >= c.mix["checked_steps"]:
            with torch.no_grad():
                for p, k in zip(params, keep):
                    p.copy_(k)
    if fault == "unchanged":
        monkeypatch.setattr(T.GanTrainer, "optimize_parameters", late_frozen)
    else:
        monkeypatch.setattr(T.GanTrainer, "set_input", late_half)
    out = run_cell(c, 95, 0.01, False, CPU)
    checks = out["checks"]
    assert not out["correct"], checks
    for early in ("loss1", "loss23", "fake1", "dparam3"):
        if early in checks:
            assert checks[early]["value"] <= checks[early]["limit"], early
    late = ("dparamw", "dparamw_med") if fault == "unchanged" else ("lossw",
                                                                    "fakew")
    assert any(checks[n]["value"] > checks[n]["limit"] for n in late
               if n in checks), checks


def test_answer_altered(monkeypatch):
    from cfen_vit_tpu_torch.models import dehazing_model as M
    test = M.DehazingModel.test

    def altered(self, cfg=None):
        out = test(self, cfg)
        out["fake_A"][0] = 255 - out["fake_A"][0]
        return out
    monkeypatch.setattr(M.DehazingModel, "test", altered)
    out = run_cell(tiny_cell("v3_infer_b32_bf16"), 94, 0.01, False, CPU)
    assert not out["correct"]
