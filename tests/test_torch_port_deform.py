"""The port's deformable convolution (cfen_vit_tpu_torch/ops/deform_conv.py,
the plain version of K6, with the DCNv2 Pack, the weight bridge and the
bench entry point) against the JAX package's ops/deform_conv.py.

Inputs are drawn with numpy from a seed and handed to both packages (NHWC
and HWIO to JAX, NCHW and OIHW to the port).  The JAX side runs its
unclamped XLA path (CFEN_PALLAS_DCN=0) unless a test calls the Pallas
kernel itself, in interpret mode as tests/test_pallas_deform.py does.  K6
itself runs only on a card: tests/test_torch_port_kernels.py (`cuda`) and
chip_smoke.py hold it against `deform_plain`.
"""

import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from cfen_vit_tpu.ops import deform_conv as JD
from cfen_vit_tpu.ops.pallas_deform import modulated_deform_conv_pallas
from cfen_vit_tpu_torch import bench_deform
from cfen_vit_tpu_torch.interop.from_jax import deform_pack_state_dict_from_jax
from cfen_vit_tpu_torch.ops import cuda_deform
from cfen_vit_tpu_torch.ops import deform_conv as TD

TOL = 3e-5     # float32: the two packages differ in summation order only


@pytest.fixture(autouse=True)
def jax_xla_path(monkeypatch):
    monkeypatch.setenv("CFEN_PALLAS_DCN", "0")


def _draw(rng, n, h, w, c, o, k, stride=1, pad=1, dil=1, off_scale=2.0):
    """x, offset, mask, w, b as float64 numpy in the JAX layouts."""
    oh = TD.out_size(h, k, stride, pad, dil)
    ow = TD.out_size(w, k, stride, pad, dil)
    return (rng.randn(n, h, w, c), rng.randn(n, oh, ow, 2 * k * k) * off_scale,
            rng.rand(n, oh, ow, k * k), rng.randn(k, k, c, o) * 0.1,
            rng.randn(o) * 0.1)


def _jax(arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrays]


def _port(arrays, dtype=torch.float32):
    x, off, mask, w, b = arrays
    nchw = [np.ascontiguousarray(a.transpose(0, 3, 1, 2)) for a in (x, off, mask)]
    oihw = np.ascontiguousarray(w.transpose(3, 2, 0, 1))
    return [torch.from_numpy(a).to(dtype) for a in nchw + [oihw, b]]


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b) / np.linalg.norm(b))


# (n, h, w, c, o, k, stride, pad, dilation, offset scale)
CASES = {
    "k3": (2, 9, 10, 4, 6, 3, 1, 1, 1, 2.0),
    "k5": (2, 9, 10, 4, 6, 5, 1, 2, 1, 2.0),
    "stride2": (1, 11, 12, 3, 5, 3, 2, 1, 1, 2.0),
    "dilation2": (1, 11, 12, 3, 5, 3, 1, 2, 2, 2.0),
    "samples_outside": (1, 6, 7, 3, 4, 3, 1, 1, 1, 4.0),
    "offsets_beyond_12": (1, 30, 32, 3, 4, 3, 1, 1, 1, 8.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_deform_plain_matches_jax_xla(rng, case):
    n, h, w, c, o, k, stride, pad, dil, scale = CASES[case]
    arrays = _draw(rng, n, h, w, c, o, k, stride, pad, dil, scale)
    off = arrays[1]
    if case == "offsets_beyond_12":
        assert (np.abs(off) > 12).sum() > 100
    if case == "samples_outside":
        assert (np.abs(off) > 3).any()
    ref, ref_p = jax.jit(lambda *a: (
        JD.modulated_deform_conv(*a, stride, pad, dil),
        JD._sample_patches(*a[:2], k, stride, pad, dil)))(*_jax(arrays))
    ref = np.asarray(ref)
    got = TD.deform_plain(*_port(arrays), stride, pad, dil)
    assert got.shape == (n, o) + ref.shape[1:3]
    np.testing.assert_allclose(_nhwc(got), ref, atol=TOL, rtol=0)
    # the sampler itself, in the JAX layout [N,OH,OW,K²,C]
    got_p = TD.sample_patches(*_port(arrays)[:2], k, stride, pad, dil)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(ref_p), atol=TOL, rtol=0)


@pytest.mark.parametrize("case", ["samples_outside", "stride2", "dilation2"])
def test_five_grads_match_jax_custom_vjp(rng, case):
    """All five grads of the port's CPU path (autograd through deform_plain,
    what K6's backward recomputes) against jax.grad through the JAX
    custom VJP `_mdc_bwd`, float32, 1e-4 in relative norm per tensor."""
    n, h, w, c, o, k, stride, pad, dil, scale = CASES[case]
    arrays = _draw(rng, n, h, w, c, o, k, stride, pad, dil, scale)
    oh, ow = arrays[1].shape[1:3]
    cot = rng.randn(n, oh, ow, o)

    def loss(*a):
        out = JD.modulated_deform_conv(*a, stride, pad, dil)
        return jnp.sum(out * jnp.asarray(cot, jnp.float32))
    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(*_jax(arrays))

    leaves = [t.requires_grad_() for t in _port(arrays)]
    out = TD.modulated_deform_conv(*leaves, stride, pad, dil)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(
        np.ascontiguousarray(cot.transpose(0, 3, 1, 2))).float())
    layouts = [(0, 2, 3, 1)] * 3 + [(2, 3, 1, 0), (0,)]
    for name, g, wnt, axes in zip("x offset mask w b".split(), got, want, layouts):
        assert _rel(g.numpy().transpose(axes), np.asarray(wnt)) < 1e-4, name


@pytest.mark.parametrize("k", [3, 5])
def test_bf16_plain_matches_jax_pallas_kernel(rng, k):
    """bf16: the plain version against the TPU kernel in interpret mode, with
    offsets inside its ±12 window (±11.5, as tests/test_pallas_deform.py
    draws them).  Both form coordinates in float32 and round the patches to
    bf16 before the float32 product; the TPU kernel also rounds the
    fractional weights to bf16, so an output may differ by a few bf16 ulps:
    atol 2e-2, rtol 1e-2."""
    n, h, w, c, o = 2, 20, 28, 8, 16
    x, off, mask, wt, b = _draw(rng, n, h, w, c, o, k, pad=k // 2, off_scale=4.0)
    arrays = (x, np.clip(off, -11.5, 11.5), mask, wt, b)
    ref = modulated_deform_conv_pallas(*_jax(arrays, jnp.bfloat16), 1, k // 2, 1,
                                       interpret=True)
    got = TD.deform_plain(*_port(arrays, torch.bfloat16), 1, k // 2, 1)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref, np.float32),
                               atol=2e-2, rtol=1e-2)


def test_jax_xla_bf16_coordinates_lose_the_fraction(rng):
    """ROADMAP Queue C: the JAX XLA path forms sampling coordinates in
    x.dtype, so in bf16 a coordinate at or above 128 has a spacing of 1 and
    the bilinear fraction is lost.  At 1x128x128x8, against float32 compute
    on the same bf16-rounded inputs, JAX's bf16 forward is more than 10% off
    in relative norm; the port's plain bf16 (float32 coordinates) is under
    1%, which is bf16 rounding of the patches and the output."""
    arrays = _draw(rng, 1, 128, 128, 8, 8, 3)
    rounded = [np.asarray(jnp.asarray(a, jnp.bfloat16), np.float64) for a in arrays]
    xla = jax.jit(lambda *a: JD.modulated_deform_conv(*a, 1, 1, 1))
    ref = np.asarray(xla(*_jax(rounded)))
    jax_bf16 = np.asarray(xla(*_jax(arrays, jnp.bfloat16)), np.float32)
    port_bf16 = _nhwc(TD.deform_plain(*_port(arrays, torch.bfloat16), 1, 1, 1))
    assert _rel(jax_bf16, ref) > 0.10
    assert _rel(port_bf16, ref) < 0.01


def test_pack_matches_jax_pack_through_the_bridge(rng):
    """A JAX Pack with a non-zero conv_offset_mask (so offsets and mask
    vary), bridged and loaded strict, equals modulated_deform_conv_pack_apply
    in float32; a fresh port Pack equals conv(x, w) * sigmoid(0) + b."""
    cin, cout, k = 4, 6, 3
    params = JD.modulated_deform_conv_pack_init(jax.random.PRNGKey(0), cin, cout, k)
    params["b"] = jnp.asarray(rng.randn(cout) * 0.1, jnp.float32)
    params["conv_offset_mask"] = {
        "w": jnp.asarray(rng.randn(k, k, cin, 3 * k * k) * 0.3, jnp.float32),
        "b": jnp.asarray(rng.randn(3 * k * k) * 0.3, jnp.float32)}
    x = rng.randn(2, 10, 11, cin).astype(np.float32)
    ref = np.asarray(jax.jit(JD.modulated_deform_conv_pack_apply)(params, jnp.asarray(x)))

    pack = TD.ModulatedDeformConvPack(cin, cout, k)
    pack.load_state_dict(deform_pack_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    with torch.no_grad():
        got = pack(xt)
    np.testing.assert_allclose(_nhwc(got), ref, atol=TOL, rtol=0)

    fresh = TD.ModulatedDeformConvPack(cin, cout, k)
    with torch.no_grad():
        fresh.bias.copy_(torch.from_numpy(rng.randn(cout).astype(np.float32)))
        want = F.conv2d(xt, fresh.weight, padding=1) * 0.5 + fresh.bias.view(1, -1, 1, 1)
        torch.testing.assert_close(fresh(xt), want, atol=1e-5, rtol=1e-5)


def test_deform_conv_v1_matches_jax(rng):
    arrays = _draw(rng, 2, 9, 8, 3, 5, 3, stride=2, off_scale=3.0)
    x, off, _, w, b = arrays
    ref = np.asarray(jax.jit(lambda *a: JD.deform_conv(*a, stride=2, pad=1))(
        *_jax((x, off, w, b))))
    px, poff, _, pw, pb = _port(arrays)
    got = TD.deform_conv(px, poff, pw, pb, stride=2, pad=1)
    np.testing.assert_allclose(_nhwc(got), ref, atol=TOL, rtol=0)


def test_cpu_wrapper_runs_plain_without_launching(rng):
    before = (cuda_deform.launches, cuda_deform.recomputes)
    args = _port(_draw(rng, 1, 7, 9, 3, 4, 3))
    torch.testing.assert_close(TD.modulated_deform_conv(*args),
                               TD.deform_plain(*args), rtol=0, atol=0)
    pack = TD.ModulatedDeformConvPack(3, 4)
    pack(args[0].requires_grad_()).sum().backward()
    assert args[0].grad is not None and pack.conv_offset_mask.weight.grad is not None
    assert (cuda_deform.launches, cuda_deform.recomputes) == before


def test_bench_deform_plain_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(bench_deform, "GEOMETRIES", [(1, 12, 10, 8, 8, 3)])
    rows = bench_deform.main(["--gpu_ids", "-1", "--paths", "plain", "--iters", "1",
                              "--dtype", "float32"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(rows) == 1
    row = json.loads(lines[0])
    assert row["geometry"] == "1x12x10x8->8 k3" and row["path"] == "plain"
    assert row["device"] == "cpu" and row["fwd_eff_mfu_pct"] is None
    assert row["k6_launches"] == 0
    for key in ("fwd_ms", "fwd_bwd_ms", "gemm_gflops", "fwd_eff_gflops"):
        assert np.isfinite(row[key]) and row[key] > 0, key
    with pytest.raises(SystemExit):          # the kernel path needs a card
        bench_deform.main(["--gpu_ids", "-1", "--paths", "cuda"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):   # the default is cuda:0
        bench_deform.main(["--paths", "plain"])
