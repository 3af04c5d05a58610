"""The alternate networks and losses of the port (cfen_vit_tpu_torch/
models/networks_alt.py, models/pvt.py, ops/actnorm_pkg.py, losses/
extra.py) against the JAX modules, weight for weight through
interop/from_jax.py, at the sizes and bars of the JAX package's own tests
(tests/test_networks_alt.py, test_pvt.py, test_actnorm_pkg.py,
test_extra_losses.py): ResnetGenerator, UnetGenerator and the Classifier's
tower 2e-5; ActNorm 1e-5; AdaIN 1e-4 and MIND 1e-4 relative.  PVT has no
bar in JAX (no golden path: the reference's cannot import); here it is
held to 1e-4 at the JAX test's 64 px and with its positions resized."""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cfen_vit_tpu.losses import extra as JE
from cfen_vit_tpu.models import networks_alt as JA
from cfen_vit_tpu.models import pvt as JP
from cfen_vit_tpu.ops import actnorm_pkg as JN
from cfen_vit_tpu.ops import nn as JNN
from cfen_vit_tpu_torch.interop import from_jax as B
from cfen_vit_tpu_torch.losses import extra as TE
from cfen_vit_tpu_torch.models import networks_alt as TA
from cfen_vit_tpu_torch.models import pvt as TP
from cfen_vit_tpu_torch.ops import actnorm_pkg as TN
from tests.torch_variant_cases import nchw, np_tree
from tests.torch_variant_cases import release_file_memory  # noqa: F401


def _port(net, tree):
    net.load_state_dict(B.module_state_dict_from_jax(np_tree(tree), net),
                        strict=True)
    return net.eval()


def _run(net, x):
    with torch.no_grad():
        out = net(nchw(x))
    return out


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), atol=atol, rtol=rtol)


def test_resnet_generator_matches_jax():
    p = jax.jit(lambda k: JA.resnet_generator_init(k, 3, 3, ngf=16,
                                                   n_blocks=2))(jax.random.PRNGKey(0))
    x = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32) * 2 - 1
    net = _port(TA.ResnetGenerator(3, 3, ngf=16, n_blocks=2), p)
    _close(_run(net, x), jax.jit(JA.resnet_generator_apply)(p, jnp.asarray(x)),
           2e-5)


def test_unet_generator_matches_jax():
    p = JA.unet_generator_init(jax.random.PRNGKey(1), 3, 3, 5, ngf=8)
    x = np.random.RandomState(1).rand(2, 32, 32, 3).astype(np.float32) * 2 - 1
    net = _port(TA.UnetGenerator(3, 3, 5, ngf=8), p)
    assert {k.split(".model.")[-1] for k in net.state_dict()} >= {
        "0.weight", "3.weight", "5.weight"}
    want = jax.jit(lambda xx: JA.unet_generator_apply(p, xx))(jnp.asarray(x))
    _close(_run(net, x), want, 2e-5)


def test_classifier_matches_jax():
    p = jax.jit(lambda k: JA.classifier_init(k, 3, ndf=8))(jax.random.PRNGKey(2))
    net = _port(TA.Classifier(3, 8), p)
    # the tower at 64 px (the last norm sees 3x3), as the JAX test holds it
    x = np.random.RandomState(2).rand(2, 64, 64, 3).astype(np.float32)

    @jax.jit
    def tower(p, h):
        h = JNN.leaky_relu(JNN.conv2d(p["c0"], h, stride=2), 0.2)
        for n in range(3):
            h = JNN.conv2d(p[f"c{n + 1}"], h, stride=2)
            h = (JNN.instance_norm(h) * p[f"in{n + 1}"]["g"]
                 + p[f"in{n + 1}"]["b"])
            h = JNN.leaky_relu(h, 0.2)
        return h
    h = tower(p, jnp.asarray(x))
    with torch.no_grad():
        tower = net.before_linear(nchw(x))
    _close(tower, h, 2e-5)
    # the whole forward where the map ends 1x1 (32 px)
    x = np.random.RandomState(3).rand(2, 32, 32, 3).astype(np.float32)
    with torch.no_grad():
        got = net(nchw(x)).numpy()
    want = np.asarray(jax.jit(JA.classifier_apply)(p, jnp.asarray(x)))
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.fixture(scope="module")
def pvt_tiny():
    spec = replace(JP.PRESETS["pvt_tiny"], img_size=64)
    params = jax.jit(lambda k: JP.pvt_init(k, spec))(jax.random.PRNGKey(0))
    tspec, _ = TP.create_pvt("pvt_tiny", img_size=64)
    return spec, params, _port(TP.PVT(tspec), params)


@pytest.mark.parametrize("side", [64, 96])
def test_pvt_tiny_matches_jax(pvt_tiny, side):
    spec, params, net = pvt_tiny
    x = np.random.RandomState(side).randn(2, side, side, 3).astype(np.float32)
    want = jax.jit(lambda p, xx: JP.pvt_apply(p, spec, xx))(
        params, jnp.asarray(x))
    got = _run(net, x)
    assert [tuple(o.shape) for o in got] == [
        (2, c, side // s, side // s)
        for c, s in zip((64, 128, 320, 512), (4, 8, 16, 32))]
    for g, w in zip(got, want):
        _close(g, w, 1e-4, rtol=1e-4)


def test_actnorm_pkg_matches_jax():
    rng = np.random.RandomState(4)
    x = (rng.randn(2, 8, 8, 5) * 2 + 1).astype(np.float32)
    want, p = JN.actnorm_pkg_apply(JN.actnorm_pkg_init(5), jnp.asarray(x),
                                   rank=2)
    m = TN.ActNorm2d(5)
    with torch.no_grad():
        got = m(nchw(x))
    _close(got, want, 1e-5)
    # the statistics stay for the next batch; JAX's tree loads into it
    x2 = (rng.randn(2, 8, 8, 5) * 3).astype(np.float32)
    want2, _ = JN.actnorm_pkg_apply(p, jnp.asarray(x2), rank=2)
    loaded = _port(TN.ActNorm2d(5), p)
    with torch.no_grad():
        _close(m(nchw(x2)), want2, 1e-5)
        _close(loaded(nchw(x2)), want2, 1e-5)
    m.reset_()
    with torch.no_grad():
        y = m(nchw(x2)).numpy()
    np.testing.assert_allclose(y.std(axis=(0, 2, 3)), 1.0, atol=1e-4)


def test_actnorm_pkg_ranks():
    base = np.random.RandomState(5).randn(2, 4, 6).astype(np.float32)  # N C L
    y1 = TN.ActNorm1d(4)(torch.tensor(base)).detach()
    y2 = TN.ActNorm2d(4)(torch.tensor(base.reshape(2, 4, 2, 3))).detach()
    y3 = TN.ActNorm3d(4)(torch.tensor(base.reshape(2, 4, 1, 2, 3))).detach()
    torch.testing.assert_close(y2.reshape(2, 4, 6), y1, atol=1e-6, rtol=0)
    torch.testing.assert_close(y3.reshape(2, 4, 6), y1, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="5D"):
        TN.ActNorm3d(5)(torch.zeros(2, 5, 3, 4))
    with pytest.raises(ValueError, match="4D"):
        TN.ActNorm2d(5)(torch.zeros(5, 3, 4))


def test_adain_matches_jax():
    rng = np.random.RandomState(6)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    y = rng.randn(2, 8, 8, 4).astype(np.float32) * 2 + 1
    got = TE.adain(nchw(x), nchw(y))
    _close(got, JE.adain(jnp.asarray(x), jnp.asarray(y)), 1e-4)


def test_mind_loss_matches_jax():
    rng = np.random.RandomState(7)
    a = rng.rand(1, 24, 24, 1).astype(np.float32)
    b = rng.rand(1, 24, 24, 1).astype(np.float32)
    _close(TE.mind(nchw(a)), JE.mind(jnp.asarray(a)), 1e-5)
    want = float(JE.mind_loss(jnp.asarray(a), jnp.asarray(b)))
    got = float(TE.mind_loss(nchw(a), nchw(b)))
    assert abs(got - want) < 1e-4 * max(1.0, abs(want))
