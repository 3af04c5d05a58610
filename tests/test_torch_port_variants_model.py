"""The port's model wrapper, server and trainer over every `--model` and
`--model_G` (cfen_vit_tpu_torch/models/dehazing_model.py, serve.py,
train/trainer.py) on the CPU at the tiny test geometry: the visual names
of the JAX DehazingModel for each of the seven `--model` values with
`--out_all` on and off, the d-only fake_A equal to the all-branch one
bit for bit, the server's reply for dec_ipt (no D branch: its refined
dh), one `--model dec_vit` training step for each of the 17 specs beside
v3 (finite losses, the JAX trainer's loss keys, every reachable parameter
moved), and create_model's dispatch of the seven names."""

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
from tests.torch_variant_cases import release_file_memory  # noqa: F401

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


def _jax_loss_keys(jtr, side):
    """The JAX trainer's G and D loss keys for its spec, read from the
    structure of _g_loss and _d_loss through jax.eval_shape (traced on
    abstract params and batch, nothing compiled or run)."""
    from cfen_vit_tpu.losses.vgg import vgg19_init
    from cfen_vit_tpu.models.discriminator import define_d
    key = jax.random.PRNGKey(0)
    g = jax.eval_shape(lambda k: generator_init(k, jtr.spec), key)
    d = {n: jax.eval_shape(lambda k: define_d(k, jtr.cfg), key)
         for n in jtr.branches.values()}
    vgg = jax.eval_shape(lambda: vgg19_init(None))
    batch = {k: jax.ShapeDtypeStruct((2, side, side, 1 if k == "S" else 3),
                                     np.float32) for k in "BARS"}
    _, (losses, fakes, reals) = jax.eval_shape(jtr._g_loss, g, d, vgg, batch)
    _, d_losses = jax.eval_shape(jtr._d_loss, d, batch, fakes, reals)
    return set(losses) | set(d_losses)


@pytest.mark.parametrize("name", C.VARIANTS)
def test_dec_vit_trains_every_spec(tmp_path, name):
    """`--model dec_vit --model_G name`: one port step on the CPU with
    finite losses, the JAX trainer's loss keys, and every parameter moved
    but those of modules no loss reaches (models/generator.py `unreached_modules`,
    which must not move) and of a CFS squeeze-excite whose hidden ReLU is zero on this
    batch (checked on the forward before the step)."""
    from cfen_vit_tpu.train.trainer import GanTrainer as JaxTrainer
    from cfen_vit_tpu_torch.models.generator import unreached_modules
    from cfen_vit_tpu_torch.train.trainer import GanTrainer
    argv = ["--name", "t", "--checkpoints_dir", str(tmp_path), "--model",
            "dec_vit", "--model_G", name, "--gpu_ids", "-1", "--batchSize",
            "2", *TINY]
    tr = GanTrainer(TC.parse_args(argv, save_opt=False), CPU)
    side = C.side(tr.spec)
    rng = np.random.RandomState(3)
    batch = {k: rng.randint(0, 256, (2, side, side, 1 if k == "S" else 3))
             .astype(np.float32) / 127.5 - 1.0 for k in "BARS"}
    tr.set_input(batch)
    dead_relu, hooks = set(), []
    for mname, m in tr.g.named_modules():
        if mname.startswith("cfsm2g") and isinstance(m, torch.nn.ReLU):
            hooks.append(m.register_forward_hook(
                lambda mod, i, o, n=mname[:-2]: dead_relu.add(n) if not o.any()
                else None))
    with torch.no_grad():   # the ActNorm init pass the step would make
        tr.g(tr._batch["B"])
    for h in hooks:
        h.remove()
    before = {k: p.detach().clone() for k, p in tr.g.named_parameters()}
    before.update({f"D.{k}": p.detach().clone()
                   for k, p in tr.d.named_parameters()})
    tr.optimize_parameters()
    losses = tr.get_current_losses()
    assert tr.step == 1 and all(np.isfinite(v) for v in losses.values()), losses
    jtr = JaxTrainer(JC.parse_args(argv, save_opt=False))
    assert set(losses) == _jax_loss_keys(jtr, side)
    after = dict(tr.g.named_parameters())
    after.update({f"D.{k}": p for k, p in tr.d.named_parameters()})
    still = {k for k in before if torch.equal(before[k], after[k])}
    dead = {k for k in before if k.split(".")[0] in unreached_modules(tr.spec)}
    assert dead <= still, sorted(dead - still)
    idle = {k for k in still - dead if k.rsplit(".", 2)[0] not in dead_relu}
    assert not idle, sorted(idle)


@pytest.mark.parametrize("is_train", [True, False])
@pytest.mark.parametrize("model", sorted(_MODEL_DEFAULT_G) + ["pix2pix"])
def test_create_model_dispatches_as_jax(tmp_path, model, is_train):
    """The seven --model values build the trainer (isTrain) or the
    inference wrapper on the JAX package's spec and branches; any other
    name raises NotImplementedError in both packages."""
    from cfen_vit_tpu.models.dehazing_model import create_model as jax_create
    from cfen_vit_tpu_torch.models.dehazing_model import create_model
    argv = ["--name", "t", "--checkpoints_dir", str(tmp_path), "--model",
            model, "--gpu_ids", "-1", *TINY]
    jcfg = JC.parse_args(argv, is_train=is_train, save_opt=False)
    tcfg = TC.parse_args(argv, is_train=is_train, save_opt=False)
    if model not in _MODEL_DEFAULT_G:
        for create, cfg in ((jax_create, jcfg), (create_model, tcfg)):
            with pytest.raises(NotImplementedError, match="not implemented"):
                create(cfg)
        return
    want, got = jax_create(jcfg), create_model(tcfg, CPU)
    assert type(got).__name__ == type(want).__name__
    assert got.spec.name == want.spec.name
    if is_train:
        assert got.branches == want.branches
