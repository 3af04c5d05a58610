"""The port's --chop and --self_ensemble (cfen_vit_tpu_torch/models/
inference_utils.py and DehazingModel) against the JAX package's, and the
identity and equivariance cases of tests/test_inference_utils.py.

The generator cases use one set of weights on both sides (the port's
seeded init read into JAX by its .pth importer, the JAX ActNorm init pass,
carried back by interop/from_jax.py) at the tiny geometry (n_feats 8, loadSize 64, 128 px
tiles) on the CPU, to 2e-4 in float32 (the JAX package's golden bar).
"""

from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cfen_vit_tpu.models import generator as JG
from cfen_vit_tpu.models import inference_utils as JI
from cfen_vit_tpu.models import registry as JR
from cfen_vit_tpu.interop.torch_import import import_generator_state_dict
from cfen_vit_tpu_torch.config import parse_args
from cfen_vit_tpu_torch.interop.from_jax import state_dict_from_jax
from cfen_vit_tpu_torch.models import inference_utils as TI
from cfen_vit_tpu_torch.models import registry as TR
from cfen_vit_tpu_torch.models.dehazing_model import DehazingModel
from cfen_vit_tpu_torch.models.generator import Generator, init_weights

BAR = 2e-4
TINY = dict(n_feats=8, load_size=64, patch_size=8, num_heads=2, hidden_dim_ratio=2)
TINY_FLAGS = ["--n_feats", "8", "--loadSize", "64", "--patch_size", "8",
              "--num_heads", "2", "--hidden_dim_ratio", "2"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_dihedral_roundtrip(rng):
    x = _t(rng.randn(2, 6, 6, 3).astype(np.float32))
    for i in range(8):
        torch.testing.assert_close(TI._dihedral_inv(TI._dihedral(x, i), i), x,
                                   rtol=0, atol=0)
        np.testing.assert_array_equal(TI._dihedral(x, i).numpy(),
                                      np.asarray(JI._dihedral(jnp.asarray(x.numpy()), i)))


def test_self_ensemble_of_equivariant_fn_is_identity(rng):
    x = _t(rng.randn(1, 8, 8, 3).astype(np.float32))
    fwd = lambda v: torch.tanh(v) * 2.0   # noqa: E731
    torch.testing.assert_close(TI.self_ensemble_x8(fwd, x), fwd(x), rtol=0, atol=1e-6)


def test_chop_identity_reconstructs(rng):
    x = _t(rng.randn(1, 50, 70, 3).astype(np.float32))
    torch.testing.assert_close(TI.chop_forward(lambda v: v, x, tile=32, overlap=8),
                               x, rtol=0, atol=1e-5)


def test_chop_matches_full_forward_for_local_fn(rng):
    """A 3x3 mean filter is local: tiled and whole outputs differ only at
    tile borders (the conv halo), and the seams are blended."""
    w = torch.ones(1, 1, 3, 3) / 9.0

    def fwd(v):
        return torch.nn.functional.conv2d(v.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)

    x = _t(rng.randn(1, 64, 96, 1).astype(np.float32))
    diff = (fwd(x) - TI.chop_forward(fwd, x, tile=32, overlap=8)).abs().numpy()
    assert np.median(diff) < 1e-6
    assert diff.mean() < 0.02


def test_chop_blend_matches_jax(rng):
    """A non-local fn (each tile minus its own mean) makes every window
    weight count."""
    x = rng.randn(2, 75, 101, 3).astype(np.float32)
    got = TI.chop_forward(lambda v: v - v.mean(dim=(1, 2), keepdim=True) * 0.5, _t(x),
                          tile=32, overlap=12)
    ref = JI.chop_forward(lambda v: v - v.mean(axis=(1, 2), keepdims=True) * 0.5,
                          jnp.asarray(x), tile=32, overlap=12)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_chop_rejects_an_image_smaller_than_the_tile():
    with pytest.raises(ValueError, match="smaller"):
        TI.chop_forward(lambda v: v, torch.zeros(1, 16, 40, 3), tile=32)


@pytest.fixture(scope="module")
def gen():
    """The tiny v3 generator on both sides, one set of weights."""
    spec = replace(JR.generator_spec("iid_hlgvit_crs_gd4_cfs_v3"), **TINY)
    tspec = replace(TR.generator_spec("iid_hlgvit_crs_gd4_cfs_v3"), **TINY)
    seeded = init_weights(Generator(tspec), torch.Generator().manual_seed(4))
    params = import_generator_state_dict(seeded.state_dict(), spec)
    x = jnp.asarray(np.random.RandomState(1).uniform(-1, 1, (1, 128, 128, 3))
                    .astype(np.float32))
    _, params = jax.jit(lambda p, xx: JG.generator_forward(
        p, spec, xx, actnorm_init=True))(params, x)
    params = jax.tree_util.tree_map(np.asarray, params)
    net = Generator(tspec).eval()
    net.load_state_dict(state_dict_from_jax(params, tspec), strict=True)
    jfwd = jax.jit(lambda xx: JG.generator_forward(params, spec, xx)["d"])

    def tfwd(v):
        with torch.no_grad():
            return net(v.permute(0, 3, 1, 2).contiguous(), branches="d")["d"].permute(0, 2, 3, 1)
    return SimpleNamespace(params=params, net=net, jfwd=jfwd, tfwd=tfwd)


def test_self_ensemble_on_generator_matches_jax(gen, rng):
    x = rng.uniform(-1, 1, (1, 128, 128, 3)).astype(np.float32)
    got = TI.self_ensemble_x8(gen.tfwd, _t(x)).numpy()
    ref = np.asarray(JI.self_ensemble_x8(gen.jfwd, jnp.asarray(x)))
    assert got.shape == (1, 128, 128, 3)
    assert np.abs(got - ref).max() < BAR


def test_chop_on_generator_matches_jax(gen, rng):
    """A 2x-larger, non-square image through 128 px tiles."""
    x = rng.uniform(-1, 1, (1, 256, 192, 3)).astype(np.float32)
    got = TI.chop_forward(gen.tfwd, _t(x), tile=128, overlap=32).numpy()
    ref = np.asarray(JI.chop_forward(gen.jfwd, jnp.asarray(x), tile=128, overlap=32))
    assert got.shape == (1, 256, 192, 3) and np.isfinite(got).all()
    assert np.abs(got - ref).max() < BAR


@pytest.mark.parametrize("flag", ["--chop", "--self_ensemble"])
def test_dehazing_model_flags_match_the_jax_model(gen, rng, tmp_path, flag):
    """DehazingModel under each flag: the float wire (uint8 off), float32
    visuals, against the JAX DehazingModel on the same weights; --chop on
    a 128 px input passes through whole."""
    from cfen_vit_tpu.config import parse_args as jax_parse_args
    from cfen_vit_tpu.models.dehazing_model import DehazingModel as JaxModel
    argv = ["--checkpoints_dir", str(tmp_path), "--out_all", "--chop_overlap", "32",
            flag, *TINY_FLAGS]
    side = (128, 192) if flag == "--chop" else (128, 128)
    x = rng.uniform(-1, 1, (2, *side, 3)).astype(np.float32)
    jm = JaxModel(jax_parse_args(argv, is_train=False, save_opt=False))
    jm.params = gen.params
    tm = DehazingModel(parse_args(argv, is_train=False, save_opt=False),
                       torch.device("cpu"))
    tm.net.load_state_dict(gen.net.state_dict())
    tm.net.eval()
    assert not tm._u8_io and not jm._u8_io
    for batch in ({"B": x, "B_paths": ["a", "b"]},
                  {"B": x[:, :128, :128], "B_paths": ["a", "b"]}):
        jm.set_input(batch)
        tm.set_input(batch)
        got, ref = tm.test()["fake_A"], jm.test()["fake_A"]
        assert got.dtype == np.float32 and got.shape == ref.shape
        assert np.abs(got - ref).max() < BAR
    if flag == "--chop":   # a tile-sized input is the plain forward
        np.testing.assert_array_equal(got, gen.tfwd(_t(x[:, :128, :128])).numpy())
