"""The port's EPDN family (cfen_vit_tpu_torch/models/epdn.py) and its
trainer (train/pix2pixhd.py) against the JAX package's
(cfen_vit_tpu/models/epdn.py, train/pix2pixhd.py) on the CPU, weight for
weight through interop/from_jax.py.

Networks: every one of the family at a tiny width, output within 1e-4
(the bar of tests/test_epdn.py), Dehaze also at a side its VALID pools
truncate (40: pools of 1, 2, 5 and 10 cells, upsampled by ratios that are
not integers).  The trainer: one step of each from the same weights at
batch 2 = pool_size, so the pool answers with its input and the step is
exact in both; losses within 1e-4 relative, grads (the first Adam
moments) within 1e-3 relative norm per network and 1e-2 plus 1e-6 per
tensor, params within 2 lr + 1e-6 (the bars of
tests/torch_train_cases.py).  And the two loss functions on their own.
"""

import gc
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cfen_vit_tpu.models import epdn as JE
from cfen_vit_tpu_torch.interop import from_jax as FJ
from cfen_vit_tpu_torch.models import epdn as TE
from tests.torch_variant_cases import one_torch_thread  # noqa: F401

BAR = 1e-4


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _close(got, want, bar=BAR):
    want = np.asarray(want)
    got = got.detach().numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    diff = np.abs(got - want).max()
    assert diff < bar, diff


def _tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# (JAX init, JAX apply, port module, bridge, input NHWC shape)
NETS = {
    "dehaze": (lambda k: JE.dehaze_init(k, 6), JE.dehaze_apply,
               lambda: TE.Dehaze(6), FJ.dehaze_state_dict_from_jax,
               (2, 64, 64, 6)),
    "dehaze_ragged": (lambda k: JE.dehaze_init(k, 6), JE.dehaze_apply,
                      lambda: TE.Dehaze(6), FJ.dehaze_state_dict_from_jax,
                      (2, 40, 40, 6)),
    "global_generator": (
        lambda k: JE.global_generator_init(k, 3, 3, 8, 2, 2),
        JE.global_generator_apply, lambda: TE.GlobalGenerator(3, 3, 8, 2, 2),
        FJ.global_generator_state_dict_from_jax, (2, 32, 32, 3)),
    "hw_sff": (lambda k: JE.hw_sff_init(k, 4, 16), None,
               lambda: TE.HeightWiseSFF(4, 16), FJ.hw_sff_state_dict_from_jax,
               (2, 16, 12, 4)),
    "omni_feature_extractor": (
        lambda k: JE.omni_feature_extractor_init(k, 3, 8, 16),
        JE.omni_feature_extractor_apply,
        lambda: TE.OmniFeatureExtractor(3, 8, 16),
        FJ.omni_feature_extractor_state_dict_from_jax, (2, 16, 24, 3)),
}


@pytest.mark.parametrize("name", sorted(NETS))
def test_network_matches_jax(name):
    init, apply, build, bridge, shape = NETS[name]
    p = _tree(init(jax.random.PRNGKey(1)))
    net = build().eval()
    net.load_state_dict(bridge(p), strict=True)
    if name == "hw_sff":
        xs = [_x(shape, i) for i in range(4)]
        want = jax.jit(JE.hw_sff_apply)(p, *xs)
        with torch.no_grad():
            _close(net(*[_nchw(x) for x in xs]), want)
        return
    x = _x(shape)
    want = jax.jit(apply)(p, x)
    with torch.no_grad():
        _close(net(_nchw(x)), want)


@pytest.mark.parametrize("omni", [False, True])
def test_local_enhancers_match_jax(omni):
    """LocalEnhancer (the JAX tree's unused global tail has no slot) and
    the reconstructed OmniLocalEnhancer: both outputs."""
    kw = dict(ngf=8, n_downsample_global=2, n_blocks_global=2,
              n_blocks_local=1)
    if omni:
        p = _tree(JE.omni_local_enhancer_init(jax.random.PRNGKey(2),
                                              n_height=32, **kw))
        net = TE.OmniLocalEnhancer(n_height=32, **kw)
        sd, apply, x = (FJ.omni_local_enhancer_state_dict_from_jax(p),
                        JE.omni_local_enhancer_apply, _x((1, 32, 32, 3)))
    else:
        p = _tree(JE.local_enhancer_init(jax.random.PRNGKey(2), **kw))
        net = TE.LocalEnhancer(**kw)
        sd, apply, x = (FJ.local_enhancer_state_dict_from_jax(p),
                        JE.local_enhancer_apply, _x((2, 64, 64, 3)))
    net.load_state_dict(sd, strict=True)
    want = jax.jit(apply)(p, x)
    with torch.no_grad():
        got = net.eval()(_nchw(x))
    for g, w in zip(got, want):
        _close(g, w)


def test_encoder_instance_mean_matches_jax():
    p = _tree(JE.encoder_init(jax.random.PRNGKey(3), 3, 3, 8, 2))
    net = TE.Encoder(3, 3, 8, 2).eval()
    net.load_state_dict(FJ.encoder_state_dict_from_jax(p), strict=True)
    x = _x((2, 32, 32, 3))
    inst = np.random.RandomState(4).randint(0, 5, (2, 32, 32, 1))
    want = jax.jit(lambda p, x, i: JE.encoder_apply(p, x, i, 8))(p, x, inst)
    with torch.no_grad():
        got = net(_nchw(x), torch.from_numpy(inst.transpose(0, 3, 1, 2)), 8)
    _close(got, want)
    # every pixel of one id holds one value: the batch-wide mean
    ids = torch.from_numpy(inst[..., 0])
    vals = got.permute(0, 2, 3, 1)[ids == 3]
    assert torch.allclose(vals, vals[:1].expand_as(vals))


@pytest.mark.parametrize("sigmoid", [False, True])
def test_multiscale_discriminator_matches_jax(sigmoid):
    """Three scales, every intermediate feature; scale i on
    layer{num_D - 1 - i} and the input pooled i times."""
    p = _tree(JE.multiscale_disc_init(jax.random.PRNGKey(5), 6, ndf=8,
                                      n_layers=3, num_d=3))
    net = TE.MultiscaleDiscriminator(6, 8, 3, 3, use_sigmoid=sigmoid).eval()
    net.load_state_dict(FJ.multiscale_disc_state_dict_from_jax(p), strict=True)
    x = _x((2, 64, 64, 6))
    want = jax.jit(lambda p, x: JE.multiscale_disc_apply(
        p, x, use_sigmoid=sigmoid, get_interm_feat=True))(p, x)
    with torch.no_grad():
        got = net(_nchw(x), get_interm_feat=True)
        last = net(_nchw(x))
    assert [len(s) for s in got] == [len(s) for s in want] == [5, 5, 5]
    for gs, ws, ls in zip(got, want, last):
        for g, w in zip(gs, ws):
            _close(g, w)
        assert len(ls) == 1 and torch.equal(ls[0], gs[-1])


def test_epdn_losses_match_jax():
    from cfen_vit_tpu.train.pix2pixhd import (
        epdn_gan_loss as jgan, feature_matching_loss as jfm)
    from cfen_vit_tpu_torch.train.pix2pixhd import (
        epdn_gan_loss, feature_matching_loss)
    rng = np.random.RandomState(6)
    fake = [[rng.randn(1, 4, 4, 3).astype(np.float32) for _ in range(5)]
            for _ in range(2)]
    real = [[rng.randn(1, 4, 4, 3).astype(np.float32) for _ in range(5)]
            for _ in range(2)]
    t = lambda ss: [[_nchw(a) for a in s] for s in ss]
    j = lambda ss: [[jnp.asarray(a) for a in s] for s in ss]
    np.testing.assert_allclose(
        float(feature_matching_loss(t(fake), t(real), 3, 2, 10.0)),
        float(jfm(j(fake), j(real), 3, 2, 10.0)), rtol=1e-6)
    for target in (True, False):
        for lsgan in (True, False):
            probs = [[1 / (1 + np.exp(-a)) for a in s] for s in fake]
            np.testing.assert_allclose(
                float(epdn_gan_loss(t(probs), target, lsgan)),
                float(jgan(j(probs), target, lsgan)), rtol=1e-6)


@pytest.fixture(scope="module")
def epdn_step(tmp_path_factory):
    """One JAX EpdnTrainer step and the port's from the same weights, both
    in float64 (JAX under enable_x64 on a float64 batch, the port's
    networks and batch in float64; the pool stays float32 in both).  In
    float32 the step is noise at these bars: the global trunk's
    InstanceNorms see 2x2 maps at this size, and JAX's own G grads came
    out 1.07e-2 (relative norm over G) off the float64 step, the port's
    5.7e-3."""
    from cfen_vit_tpu.config import Config as JC
    from cfen_vit_tpu.train.pix2pixhd import EpdnTrainer as JaxEpdn
    from cfen_vit_tpu_torch.config import Config as TC
    from cfen_vit_tpu_torch.interop.from_jax import vgg_state_dict_from_jax
    from cfen_vit_tpu_torch.train.pix2pixhd import EpdnTrainer

    kw = dict(name="ep", isTrain=True, ndf=8, epdn_ngf=4, pool_size=2,
              batchSize=2, num_D=2,
              checkpoints_dir=str(tmp_path_factory.mktemp("epdn")))
    rng = np.random.RandomState(7)
    batch = {k: rng.randint(0, 256, (2, 64, 64, 3)) / 127.5 - 1.0
             for k in "AB"}
    with jax.enable_x64(True):
        jcfg = JC(**kw)
        jtr = JaxEpdn(jcfg)
        jtr.set_input(batch)
        jtr.init_state(jtr._batch)
        before = _tree({k: jtr.state[k] for k in ("g", "d")})
        vgg = _tree(jtr.vgg)
        jtr.optimize_parameters(jcfg)
        after = _tree({k: jtr.state[k] for k in ("g", "d", "g_opt", "d_opt")})
        jlosses = jtr.get_current_losses()
    del jtr
    gc.collect()
    jax.clear_caches()

    ptr = EpdnTrainer(TC(**kw), torch.device("cpu"))
    for net in (ptr.g, ptr.d, ptr.vgg):
        net.double()
    ptr.load_state_dicts(
        g=FJ.local_enhancer_state_dict_from_jax(before["g"]),
        d=FJ.multiscale_disc_state_dict_from_jax(before["d"]),
        vgg=vgg_state_dict_from_jax(vgg))
    ptr.set_input(batch)
    assert ptr._batch["B"].dtype == torch.float64
    ptr.optimize_parameters()
    return SimpleNamespace(ptr=ptr, after=after, lr=jcfg.lr, jlosses=jlosses,
                           plosses=ptr.get_current_losses())


def _nets(s):
    """(name, port module, port optimizer, bridge of a JAX tree, key)."""
    yield ("G", s.ptr.g, s.ptr.g_opt, FJ.local_enhancer_state_dict_from_jax,
           "g")
    yield ("D", s.ptr.d, s.ptr.d_opt, FJ.multiscale_disc_state_dict_from_jax,
           "d")


def test_epdn_trainer_losses_match_jax(epdn_step):
    s = epdn_step
    assert set(s.plosses) == set(s.jlosses) == {
        "G_GAN", "G_GAN_Feat", "G_VGG", "G_L2", "D_fake", "D_real", "G"}
    for k, ref in s.jlosses.items():
        assert abs(s.plosses[k] - ref) <= 1e-4 * abs(ref), (k, s.plosses[k],
                                                            ref)


def test_epdn_trainer_grads_match_jax(epdn_step):
    s = epdn_step
    for net, module, opt, bridge, key in _nets(s):
        ref_mu = bridge(s.after[f"{key}_opt"].mu)
        diffs, refs = [], []
        for name, p in module.named_parameters():
            m, ref = opt.state[p]["exp_avg"].double(), ref_mu[name].double()
            err = (m - ref).norm()
            assert err <= 1e-2 * ref.norm() + 1e-6, (net, name)
            diffs.append(err ** 2)
            refs.append(ref.norm() ** 2)
        assert (sum(diffs) / sum(refs)).sqrt() < 1e-3, net


def test_epdn_trainer_params_match_jax(epdn_step):
    s = epdn_step
    bound = 2 * s.lr + 1e-6
    for net, module, _, bridge, key in _nets(s):
        ref = bridge(s.after[key])
        for name, p in module.named_parameters():
            diff = (p.detach() - ref[name]).abs().max().item()
            assert diff <= bound, (net, name, diff)
    assert s.ptr.step == 1 and s.ptr.pool["n"] == 2
