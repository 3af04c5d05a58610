"""The control of each cell comes out not correct: the plain reference,
computed one precision below the configuration's (TF32 for float32,
fp8 for bf16: benchmark/reference/lowp.py), in the program's place, held
to the cell's own limits against the reference.  At a tiny geometry on
the CPU; the chip readings the limits were set from are in PERF.md."""

import pytest
import torch

from benchmark import check
from benchmark.loops import infer_closed as I
from benchmark.loops import train_closed as T
from benchmark.tests.tiny import CPU, tiny_cell


@pytest.mark.parametrize("cell", ["v3_train_b4_fp32", "mgvit_train_b4_fp32",
                                  "v3_train_b4_bf16"])
def test_training_control_fails(cell):
    c = tiny_cell(cell)
    trainer, pool, state = T.setup_program(c.config, c.mix, 31, CPU)
    T.program_readings(trainer, pool, state, c.mix)
    batch = pool[c.mix["checked_steps"]]
    after = (T.program_after(trainer, batch)[0], batch)
    want = T.reference_readings(c.config, c.mix, 31, pool, CPU, after=after)
    ctrl = T.reference_readings(c.config, c.mix, 31, pool, CPU, after=after,
                                control=c.mix["control"])
    ok, numbers = check.verdict(check.train_checks(ctrl, want), c.limits)
    assert not ok, numbers


def test_inference_control_fails():
    c = tiny_cell("v3_infer_b32_bf16")
    pool = I.hazy.scenes(c.mix["pool_images"], c.config["image_side"], 32,
                         CPU)["hazy"]
    keys = list(range(c.mix["pool_images"] // c.mix["batch"]))
    want = I.reference_outputs(c.config, c.mix, pool, keys, 32, CPU)
    ctrl = I.reference_outputs(c.config, c.mix, pool, keys, 32, CPU,
                               control=c.mix["control"])
    got = {k: [v] for k, v in ctrl.items()}
    ok, numbers = check.verdict({"worst_rmse_u8": check.worst_rmse_u8(got, want)},
                                c.limits)
    assert not ok, numbers


def test_rounding_is_what_it_says():
    from benchmark.reference.lowp import round_fp8, round_tf32
    # TF32 keeps 10 mantissa bits: 2^-10 is the step at 1
    x = torch.tensor([1.0 + 2 ** -12, 1.0 + 2 ** -10 + 2 ** -12, 3.0])
    assert round_tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, 3.0]
    y = torch.linspace(-2, 2, 101)
    rel = ((round_fp8(y) - y).abs() / y.abs().clamp_min(1e-3)).max()
    assert 0 < rel < 2 ** -3
