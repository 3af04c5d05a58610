"""The all-branches inference cell (loops/infer_closed_all.py) at a tiny
geometry on the CPU: a sound run is correct under the cell's own limit,
and a run whose wrapper alters, or leaves out, any one of the four
outputs it reads back is not (the chip check is skipped)."""

import numpy as np
import pytest
import torch

from benchmark.run import run_cell
from benchmark.tests.tiny import CPU, tiny_cell

CELL = "v3_infer_b32_all_bf16"


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_sound_run_is_correct():
    out = run_cell(tiny_cell(CELL), 2 ** 33 + 11, 0.01, False, CPU)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["fake_A", "fake_R", "fake_S", "real_B",
                                   "no fake_S"])
def test_output_altered_or_left_out(fault, monkeypatch):
    from cfen_vit_tpu_torch.models import dehazing_model as M
    test = M.DehazingModel.test

    def altered(self, cfg=None):
        out = test(self, cfg)
        if fault.startswith("no "):
            del out[fault[3:]]
        else:
            out[fault][0] = 255 - out[fault][0]
        return out
    monkeypatch.setattr(M.DehazingModel, "test", altered)
    out = run_cell(tiny_cell(CELL), 2 ** 33 + 12, 0.01, False, CPU)
    assert not out["correct"]
    assert out["checks"]["worst_rmse_u8"]["value"] > 8 or not np.isfinite(
        out["checks"]["worst_rmse_u8"]["value"])
