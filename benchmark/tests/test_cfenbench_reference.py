"""The frozen plain reference against the port (cfen_vit_tpu_torch) at a
tiny geometry on the CPU, where the port runs its plain paths: the same
state dict gives the same outputs, init pass included, and the same GAN
steps."""

import pytest
import torch

from benchmark.reference.nets import Generator, gen_spec
from benchmark.reference.weights import build, draw, draw_all
from benchmark.run import run_cell
from benchmark.tests.tiny import CPU, SWITCHES, tiny_cell

TINY = dict(n_feats=8, patch_size=8, num_heads=2, hidden_dim_ratio=2)


def _port(name, load):
    from cfen_vit_tpu_torch.config import Config
    from cfen_vit_tpu_torch.models.generator import Generator as PortG
    from cfen_vit_tpu_torch.models.registry import generator_spec
    return PortG(generator_spec(name, Config(loadSize=load, **TINY)))


@pytest.mark.parametrize("name,load,side", [
    ("iid_hlgvit_crs_gd4_cfs_v3", 64, 128), ("dec_ipt", 64, 64)])
@pytest.mark.parametrize("branches", [None, "d"])
def test_generator_matches_port(name, load, side, branches):
    torch.manual_seed(0)
    spec = gen_spec(name, SWITCHES[name], load_size=load, **TINY)
    if branches == "d" and "d" not in spec.branches:
        pytest.skip(f"{name} has no D branch")
    with torch.device("meta"):
        meta = Generator(spec)
    state = draw(meta, 5, "G", CPU)
    ref = build(lambda: Generator(spec), state, CPU)
    port = _port(name, load)
    port.load_state_dict(state, strict=True)
    x = torch.rand(2, 3, side, side) * 2 - 1
    with torch.no_grad():
        ref(x, init=True)
        first = port(x)                      # the port's init pass
        assert port.actnorms_ready()
        for k, v in ref.state_dict().items():
            assert torch.equal(v, port.state_dict()[k]), k
        want = ref(x * 0.5, branches=branches)
        got = port(x * 0.5, branches=branches)
    assert set(got) == set(want) and first
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-6)


def test_draw_is_seeded_and_named():
    spec = gen_spec("iid_hlgvit_crs_gd4_cfs_v3", SWITCHES["iid_hlgvit_crs_gd4_cfs_v3"],
                    load_size=64, **TINY)
    a = draw_all(spec, ["A", "R", "S"], 2 ** 40 + 3, CPU)
    b = draw_all(spec, ["A", "R", "S"], 2 ** 40 + 3, CPU)
    c = draw_all(spec, ["A", "R", "S"], 2 ** 40 + 4, CPU)
    for k, v in a["G"].items():
        assert torch.equal(v, b["G"][k])
    w = "head.0.0.weight"
    assert not torch.equal(a["G"][w], c["G"][w])
    assert not torch.equal(a["D"]["A"]["model.0.weight"],
                           a["D"]["R"]["model.0.weight"])
    std = a["G"][w].std().item()
    assert abs(std - (2 / 75) ** 0.5) < 0.2 * (2 / 75) ** 0.5


@pytest.mark.parametrize("cell", ["v3_train_b4_fp32", "mgvit_train_b4_fp32"])
def test_float32_step_matches_port(cell):
    """Three GAN steps of the port's GanTrainer on its CPU plain paths and
    of the reference, from the same weights and batches: every number of
    the check reads 0."""
    out = run_cell(tiny_cell(cell), 77, 0.01, False, CPU)
    assert out["correct"] and out["failed"] == 0
    for name, n in out["checks"].items():
        assert n["value"] == 0.0, (name, n)


def test_inference_matches_port():
    out = run_cell(tiny_cell("v3_infer_b32_bf16"), 78, 0.01, False, CPU)
    assert out["correct"] and out["attempted"] >= 1
    assert out["checks"]["worst_rmse_u8"]["value"] < 4.0
