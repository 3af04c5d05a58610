"""The port's model wrapper, server and trainer over every `--model` and
`--model_G` (cfen_vit_tpu_torch/models/dehazing_model.py, serve.py,
train/trainer.py) on the CPU at the tiny test geometry: the visual names
of the JAX DehazingModel for each of the seven `--model` values with
`--out_all` on and off, the d-only fake_A equal to the all-branch one
bit for bit, the server's reply for dec_ipt (no D branch: its refined
dh), and the dec_vit trainer's refusal of every spec but v3."""

import numpy as np
import pytest
import torch

import jax

from cfen_vit_tpu import config as JC
from cfen_vit_tpu.models.dehazing_model import DehazingModel as JaxModel
from cfen_vit_tpu.models.generator import generator_init
from cfen_vit_tpu_torch import config as TC
from cfen_vit_tpu_torch import serve
from cfen_vit_tpu_torch.models.dehazing_model import (_MODEL_DEFAULT_G,
                                                      DehazingModel)
from cfen_vit_tpu_torch.models.generator import Generator, init_weights
from tests import torch_variant_cases as C
from tests.torch_variant_cases import one_torch_thread  # noqa: F401

TINY = ["--n_feats", "8", "--loadSize", "64", "--patch_size", "8",
        "--num_heads", "2", "--hidden_dim_ratio", "2"]
CPU = torch.device("cpu")


def _argv(tmp, model, out_all):
    return (["--name", "t", "--checkpoints_dir", str(tmp), "--model", model,
             "--gpu_ids", "-1", *TINY] + (["--out_all"] if out_all else []))


def _initialised(net, side, seed=5):
    """Seeded weights and an ActNorm init pass on a seeded batch."""
    init_weights(net, torch.Generator().manual_seed(seed)).eval()
    with torch.no_grad():
        net(torch.from_numpy(np.random.RandomState(seed).uniform(
            -1, 1, (2, 3, side, side)).astype(np.float32)))
    return net


def _jax_visual_names(argv, batch):
    """JAX DehazingModel.test()'s visual names; its params and jitted
    forward traced, not run: the forward is swapped for zeros of the
    shapes it would return."""
    model = JaxModel(JC.parse_args(argv, is_train=False, save_opt=False))
    params = jax.eval_shape(lambda k: generator_init(k, model.spec),
                            jax.random.PRNGKey(0))
    fwd = model._fwd

    def zeros(p, x):
        return {k: np.zeros(v.shape, v.dtype)
                for k, v in jax.eval_shape(fwd, p, x).items()}
    model._fwd = zeros
    model.params = params
    model.set_input({"B": batch, "B_paths": ["a", "b"]})
    return sorted(model.test())


@pytest.mark.parametrize("out_all", [False, True])
@pytest.mark.parametrize("model", sorted(_MODEL_DEFAULT_G))
def test_visual_names_match_jax(tmp_path, model, out_all):
    argv = _argv(tmp_path, model, out_all)
    port = DehazingModel(TC.parse_args(argv, is_train=False, save_opt=False), CPU)
    side = C.side(port.spec)
    _initialised(port.net, side)
    batch = np.random.RandomState(0).randint(0, 256, (2, side, side, 3),
                                             dtype=np.uint8)
    port.set_input({"B": batch, "B_paths": ["a", "b"]})
    got = port.test()
    assert sorted(got) == _jax_visual_names(argv, batch)
    assert port.d_only == (out_all and "d" in port.spec.branches)
    for v in got.values():
        assert v.shape[:3] == (2, side, side) and v.dtype == np.uint8


@pytest.mark.parametrize("name", [n for n in sorted(C.VARIANTS + [C.V3])
                                  if "d" in C.specs(n)[1].branches
                                  and C.specs(n)[1].branches != "d"])
def test_d_only_fake_a_equals_all_branches(name):
    spec = C.specs(name)[1]
    net = _initialised(Generator(spec), C.side(spec))
    x = torch.from_numpy(np.random.RandomState(1).uniform(
        -1, 1, (2, 3, C.side(spec), C.side(spec))).astype(np.float32))
    with torch.no_grad():
        full, d_only = net(x), net(x, branches="d")
    assert sorted(d_only) == ["d"]
    torch.testing.assert_close(d_only["d"], full["d"], rtol=0, atol=0)


def test_serve_answers_dec_ipt_with_its_refined_output(tmp_path):
    """dec_ipt's branches are r and s: the server returns dh, on the uint8
    path (forward_u8) and through model.test()'s fake_A alike."""
    spec = C.specs("dec_ipt")[1]
    net = _initialised(Generator(spec), C.side(spec))
    (tmp_path / "t").mkdir()
    torch.save(net.state_dict(), tmp_path / "t" / "3_net_G.pth")
    argv = _argv(tmp_path, "dec_mgvit", False) + ["--which_epoch", "3"]
    cfg, model, _ = serve.build_model(argv)
    assert model.spec.name == "dec_ipt" and not model.d_only
    img = np.random.RandomState(2).randint(0, 256, (64, 64, 3), dtype=np.uint8)
    batcher = serve.Batcher(cfg, model, max_batch=1, window_ms=0)
    try:
        got = batcher.submit(img)
    finally:
        batcher.close()
    with torch.inference_mode():
        want = model.forward_u8(torch.from_numpy(img[None]))
    assert sorted(want) == ["dh", "r", "s"]
    np.testing.assert_array_equal(got, want["dh"][0].numpy())
    model.set_input({"B": img[None], "B_paths": ["a"]})
    np.testing.assert_array_equal(model.test(cfg)["fake_A"][0], got)


@pytest.mark.parametrize("name", C.VARIANTS)
def test_dec_vit_trainer_refuses_specs_but_v3(tmp_path, name):
    from cfen_vit_tpu_torch.train.trainer import GanTrainer
    cfg = TC.parse_args(["--name", "t", "--checkpoints_dir", str(tmp_path),
                         "--model", "dec_vit", "--model_G", name,
                         "--gpu_ids", "-1", *TINY], save_opt=False)
    with pytest.raises(NotImplementedError, match="Queue A item 9"):
        GanTrainer(cfg, CPU)
