"""The traced path on the card at a tiny geometry: the profiler's device
records reach every per-layer reader of the cell, and the run is
correct.  Needs an NVIDIA GPU; skips without one."""

import pytest
import torch

from benchmark.run import run_cell
from benchmark.tests.tiny import tiny_cell


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["v3_infer_b32_bf16", "v3_train_b4_fp32"])
def test_traced_run_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    c = tiny_cell(cell)
    out = run_cell(c, 2 ** 32 + 17, 0.5, True, torch.device("cuda", 0))
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
    assert out["device"]["busy_s"] <= out["device"]["window_s"]
    assert set(out["metrics"]) == {m["name"] for m in c.per_layer}
    for m in out["metrics"].values():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 100
