"""K5, the flash-MRF core (cfen_vit_tpu_torch/ops/cuda_mrf.py), against the
JAX package's ops/pallas_mrf.py.

On the CPU the kernel wrappers run their plain twins, so `MrfCore` (the
port's custom backward) runs its glue with them; it is held against the
JAX `mrf_core` in interpret mode, as tests/test_pallas_mrf.py runs it, and
`mrf_core_plain` against the JAX dense core under autodiff.  Bars are the
JAX package's own: values within 1e-4 relative, grads within atol 2e-4,
rtol 2e-3 (tests/test_pallas_mrf.py).

The kernels themselves run only on the card: the tests marked `cuda` hold
each against its twin there and skip without one.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cfen_vit_tpu.ops import pallas_mrf as JM
from cfen_vit_tpu_torch.ops import cuda_mrf as M

VAL, ATOL, RTOL = 1e-4, 2e-4, 2e-3


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _inputs(case, n=2, p=256, c=128, seed=11):
    rng = np.random.RandomState(seed)
    o, t = _unit(rng.randn(n, p, c)), _unit(rng.randn(n, p, c))
    if case == "clamp":          # cos[q, q] = 1.008: m == 0 on 8 rows
        t[:, :8] = o[:, :8] * 1.008
    elif case == "dup":          # duplicated t rows: argmin ties
        t[:, 40:60] = t[:, 0:20]
        o[:, 100:110] = o[:, 0:10]   # duplicated o rows: argmax ties
    return o, t


def _dense_core(o_n, t_n):
    cos = jnp.einsum("nqc,npc->nqp", o_n, t_n)
    cd = jnp.maximum(-(cos - 1.0) / 2.0, 0.0)
    be = jnp.exp((1.0 - cd / (jnp.min(cd, axis=2, keepdims=True) + 1e-5)) / 0.5)
    cs = be / jnp.sum(be, axis=2, keepdims=True)
    return jnp.sum(-jnp.log(jnp.mean(jnp.max(cs, axis=1), axis=1)))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("CFEN_PALLAS_INTERPRET", "1")


def _torch_value_and_grads(fn, o, t):
    a, b = torch.tensor(o, requires_grad=True), torch.tensor(t, requires_grad=True)
    loss = fn(a, b)
    loss.backward()
    return loss.item(), a.grad.numpy(), b.grad.numpy()


@pytest.mark.parametrize("case", ["random", "clamp", "dup"])
def test_mrf_core_matches_jax_kernel_path(interpret, case):
    """MrfCore on the plain twins against the JAX custom VJP: both put the
    argmin term on the first index of a tie."""
    o, t = _inputs(case)
    ref, (gro, grt) = jax.value_and_grad(JM.mrf_core, argnums=(0, 1))(
        jnp.asarray(o), jnp.asarray(t))
    val, go, gt = _torch_value_and_grads(M.MrfCore.apply, o, t)
    assert np.isfinite(val) and abs(val - float(ref)) < VAL * abs(float(ref))
    np.testing.assert_allclose(go, np.asarray(gro), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(gt, np.asarray(grt), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("case", ["random", "clamp"])
def test_mrf_core_plain_matches_jax_dense(case):
    """The blocked dense form (three q-blocks, one ragged) under autograd
    against JAX autodiff of the dense core."""
    o, t = _inputs(case)
    ref, (gro, grt) = jax.value_and_grad(_dense_core, argnums=(0, 1))(
        jnp.asarray(o), jnp.asarray(t))
    val, go, gt = _torch_value_and_grads(
        lambda a, b: M.mrf_core_plain(a, b, block=100), o, t)
    assert abs(val - float(ref)) < VAL * abs(float(ref))
    np.testing.assert_allclose(go, np.asarray(gro), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(gt, np.asarray(grt), atol=ATOL, rtol=RTOL)


def test_forward_stats_twin_matches_jax_kernel(interpret):
    """Row and column statistics, with the first index on every tie."""
    o, t = _inputs("dup")
    jm, jz, jps, jk, jqs = JM._mrf_forward_stats(jnp.asarray(o), jnp.asarray(t),
                                                  interpret=True)
    m, z, ps, k, qs = M.mrf_forward_stats_plain(torch.tensor(o), torch.tensor(t),
                                                block=96)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm)[..., 0], atol=1e-6)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz)[..., 0], rtol=1e-5)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk)[:, 0], rtol=1e-5)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(jps)[..., 0])
    np.testing.assert_array_equal(qs.numpy(), np.asarray(jqs)[:, 0])
    # the ties the case was built for: t[40:60] == t[0:20], o[100:110] ==
    # o[0:10], so no first index lies in the copies
    assert np.any(ps.numpy() < 20) and np.any(qs.numpy() < 10)
    assert not np.any((ps.numpy() >= 40) & (ps.numpy() < 60))
    assert not np.any((qs.numpy() >= 100) & (qs.numpy() < 110))


def test_backward_twins_match_jax_kernels(interpret):
    o, t = _inputs("clamp")
    rng = np.random.RandomState(3)
    jo, jt = jnp.asarray(o), jnp.asarray(t)
    jm, jz, _, _, jqs = JM._mrf_forward_stats(jo, jt, interpret=True)
    dz = (rng.randn(2, 256, 1) * 1e-4).astype(np.float32)
    dk = (-rng.rand(2, 1, 1) * 1e-3).astype(np.float32)
    jdo, jdt, jdm = JM._mrf_backward(jo, jt, jm, jz, jnp.asarray(dz), jqs,
                                     jnp.asarray(dk), interpret=True)
    args = [torch.tensor(np.asarray(a)) for a in (o, t)] + [
        torch.tensor(np.asarray(jm)[..., 0]), torch.tensor(np.asarray(jz)[..., 0]),
        torch.tensor(dz[..., 0]), torch.tensor(np.asarray(jqs)[:, 0]).long(),
        torch.tensor(dk[:, 0, 0])]
    do, dm = M.mrf_bwd_do_plain(*args, block=100)
    dt = M.mrf_bwd_dt_plain(*args, block=100)
    for got, ref in ((do, jdo), (dt, jdt), (dm, np.asarray(jdm)[..., 0])):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                                   atol=1e-5 * np.abs(ref).max())


def test_wrappers_run_twins_on_cpu_without_launching():
    o, t = (torch.tensor(a) for a in _inputs("random", p=64))
    before = (M.fwd_launches, M.do_launches, M.dt_launches)
    stats = M.mrf_forward_stats(o, t)
    for a, b in zip(stats, M.mrf_forward_stats_plain(o, t)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    m, z, _, k, qs = stats
    dz, dk = torch.full_like(m, 1e-4), torch.full((2,), -1e-3)
    torch.testing.assert_close(M.mrf_bwd_do(o, t, m, z, dz, qs, dk),
                               M.mrf_bwd_do_plain(o, t, m, z, dz, qs, dk))
    torch.testing.assert_close(M.mrf_bwd_dt(o, t, m, z, dz, qs, dk),
                               M.mrf_bwd_dt_plain(o, t, m, z, dz, qs, dk))
    assert M.mrf_core(o, t).item() == M.mrf_core_plain(o, t).item()
    assert (M.fwd_launches, M.do_launches, M.dt_launches) == before


# --------------------------------------------------------------------------
# on the card: each kernel against its plain twin
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_inputs(dev, dtype, n, p, c, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    o, t = (torch.nn.functional.normalize(
        torch.randn(n, p, c, generator=g, device=dev), dim=-1).to(dtype)
        for _ in range(2))
    return o, t


# forward statistics are float32 from the same bf16 or f32 inputs; they
# differ by the cos summation order only.  do/dt: float32 sums over P
# terms in another order; bf16 outputs by a rounding flip.
_STAT_RTOL = 1e-4
_GRAD_TOL = {torch.float32: (1e-3, 1e-4), torch.bfloat16: (2e-2, 1e-2)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,p,c", [(2, 300, 128), (1, 1000, 256), (2, 640, 512),
                                   (4, 16384, 256),     # relu3_1 at 512x512, batch 4
                                   (4, 4096, 512)])     # relu4_1
def test_cuda_mrf_kernels_match_twins(cuda, dtype, n, p, c):
    _check_kernels_against_twins(cuda, dtype, *_card_inputs(cuda, dtype, n, p, c))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [256, 512])
def test_cuda_mrf_backward_near_ties(cuda, dtype, c):
    """t equals o on half the rows plus noise of 1e-3 an element, so m is
    near 0 there and every backward term is divided by m + 1e-5.  Each side
    runs on its own forward's statistics: where the do and dt kernels form
    other cos bits than the forward kernel, cd at a row's argmin is no
    longer m, and the disagreement, magnified by 1/(m + 1e-5), shows
    against the twins (whose forward and backward agree by construction)."""
    n, p = 2, 512
    o, t = (x.float() for x in _card_inputs(cuda, torch.float32, n, p, c, seed=3))
    g = torch.Generator(device=cuda).manual_seed(4)
    near = o[:, : p // 2] + 1e-3 * torch.randn(n, p // 2, c, generator=g, device=cuda)
    t[:, : p // 2] = torch.nn.functional.normalize(near, dim=-1)
    o, t = o.to(dtype), t.to(dtype)
    res = []
    for fwd, do_fn, dt_fn in ((M.mrf_forward_stats, M.mrf_bwd_do, M.mrf_bwd_dt),
                              (M.mrf_forward_stats_plain, M.mrf_bwd_do_plain,
                               M.mrf_bwd_dt_plain)):
        m, z, _, k, qs = fwd(o, t)
        dk = (-1.0 / (k.mean(dim=1) * p)).contiguous()
        offs = torch.arange(n, device=cuda)[:, None] * p
        sum_kq = torch.zeros(n * p, device=cuda).index_add_(
            0, (qs + offs).reshape(-1), k.reshape(-1)).view(n, p)
        dz = (-dk[:, None] * sum_kq / z).contiguous()
        res.append((m, *do_fn(o, t, m, z, dz, qs, dk), dt_fn(o, t, m, z, dz, qs, dk)))
    torch.cuda.synchronize()
    # the near ties are near: float32 m about 6e-5 (C 256) to 1.3e-4 (C
    # 512); bf16 rounding of unit rows moves cos by up to about 1e-3, so
    # some m fall to 0 (cos >= 1, the mask) and others rise to a few 1e-4
    m = res[1][0]
    assert float(m[:, : p // 2].max()) < (2e-4 if dtype == torch.float32 else 1e-3)
    rtol, frac = _GRAD_TOL[dtype]
    for name, a, b in zip(("do", "dm", "dt"), res[0][1:], res[1][1:]):
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol,
                                   atol=frac * b.float().abs().max().item(), msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", M.CHANNELS)
def test_cuda_mrf_kernels_ragged_p_each_channel_count(cuda, dtype, c):
    """P = 1000 is ragged against the forward's 128-row strips, the
    backward's 32-row strips and the 64-row tiles at both ends."""
    _check_kernels_against_twins(cuda, dtype, *_card_inputs(cuda, dtype, 2, 1000, c))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_mrf_ties_take_the_first_index(cuda, dtype):
    """Rows 2i and 2i + 1 of o, and of t, are equal: every p* and q* is a
    tie, which the kernels resolve to the first index as the twins do,
    though their fragments visit columns out of order."""
    o, t = _card_inputs(cuda, dtype, 2, 300, 256)
    o, t = (x.view(2, 150, 2, 256)[:, :, :1].expand(2, 150, 2, 256)
            .reshape(2, 300, 256).contiguous() for x in (o, t))
    got = M.mrf_forward_stats(o, t)
    ref = M.mrf_forward_stats_plain(o, t)
    for i, name in ((2, "p*"), (4, "q*")):
        assert torch.equal(got[i], ref[i]), name
        assert bool((got[i] % 2 == 0).all()), name
    _check_kernels_against_twins(cuda, dtype, o, t)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_mrf_kernels_take_inputs_off_16_byte_alignment(cuda, dtype):
    """Contiguous views one element into their storage cannot go through
    cp.async's 16-byte copies; the wrappers copy them to aligned storage."""
    o, t = (torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(x.shape)
            for x in _card_inputs(cuda, dtype, 2, 300, 128))
    assert o.data_ptr() % 16 != 0 and o.is_contiguous()
    _check_kernels_against_twins(cuda, dtype, o, t)


def _check_kernels_against_twins(cuda, dtype, o, t):
    n, p, _ = o.shape
    before = (M.fwd_launches, M.do_launches, M.dt_launches)
    got = M.mrf_forward_stats(o, t)
    ref = M.mrf_forward_stats_plain(o, t)
    for name, a, b in zip(("m", "z", "p*", "k", "q*"), got, ref):
        if a.dtype == torch.int64:
            assert (a != b).float().mean().item() < 1e-3, name
        else:
            torch.testing.assert_close(a, b, rtol=_STAT_RTOL, atol=1e-7, msg=name)
    m, z, _, k, qs = ref
    g = torch.Generator(device=cuda).manual_seed(1)
    dz = torch.randn(n, p, generator=g, device=cuda) * 1e-4
    dk = -torch.rand(n, generator=g, device=cuda) * 1e-3
    rtol, frac = _GRAD_TOL[dtype]
    for kern, twin in ((M.mrf_bwd_do, M.mrf_bwd_do_plain),
                       (M.mrf_bwd_dt, M.mrf_bwd_dt_plain)):
        outs = kern(o, t, m, z, dz, qs, dk)
        refs = twin(o, t, m, z, dz, qs, dk)
        for a, b in zip(outs if isinstance(outs, tuple) else (outs,),
                        refs if isinstance(refs, tuple) else (refs,)):
            torch.testing.assert_close(a.float(), b.float(), rtol=rtol,
                                       atol=frac * b.float().abs().max().item())
    torch.cuda.synchronize()
    assert (M.fwd_launches, M.do_launches, M.dt_launches) == tuple(
        x + 1 for x in before)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_mrf_core_matches_plain(cuda, dtype):
    o, t = _card_inputs(cuda, dtype, 2, 1024, 256)
    res = []
    for fn in (M.mrf_core, M.mrf_core_plain):
        a, b = (x.detach().clone().requires_grad_() for x in (o, t))
        loss = fn(a, b)
        loss.backward()
        res.append((loss.item(), a.grad.float(), b.grad.float()))
    (v, go, gt), (rv, rgo, rgt) = res
    assert abs(v - rv) < VAL * abs(rv)
    rtol, frac = _GRAD_TOL[dtype]
    for a, b in ((go, rgo), (gt, rgt)):
        torch.testing.assert_close(a, b, rtol=rtol, atol=frac * b.abs().max().item())


@pytest.mark.cuda
def test_cuda_mrf_rejects_what_the_kernels_do_not_take(cuda):
    o = torch.randn(1, 64, 96, device=cuda)
    with pytest.raises(ValueError, match="C in"):
        M.mrf_forward_stats(o, o)
    with pytest.raises(TypeError):
        M.mrf_forward_stats(o.half(), o.half())
