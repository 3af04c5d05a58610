"""Why the float32 kernels split their operands for the tensor cores.

K1 (csrc/attn.cuh) and K5's cos tiles (csrc/mrf.cu) take float32 inputs
through 3xTF32: each operand x becomes hi = tf32(x) and lo = tf32(x - hi),
and a product a b is hi_a hi_b + hi_a lo_b + lo_a hi_b on TF32 tensor
cores.  These tests emulate that arithmetic on the CPU (TF32 rounding as
`cvt.rna.tf32.f32` does it: 10 explicit mantissa bits, to nearest, ties
away from zero; the TF32 products are exact in float32, summed in float32)
and hold it against float64 at a K1 LViT shape and a K5 strip: the split
meets the bars the card holds the kernels to, and a single TF32 pass does
not.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from cfen_vit_tpu_torch.ops import cuda_attn
from cfen_vit_tpu_torch.ops import cuda_mrf as M

# chip_smoke.py TOL["float32"]: K1 against attention_core
K1_ATOL, K1_RTOL = 1e-4, 1e-5
# chip_smoke.py _check_mrf_stats: K5's forward statistics against the twin
STAT_RTOL, STAT_ATOL = 1e-4, 1e-6


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32: add half of the 13 dropped bits to the
    magnitude, then clear them (round to nearest, ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def matmul_tf32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (float32) as the kernels form it: small cross terms first."""
    ah, al = split(a)
    bh, bl = split(b)
    return al @ bh + ah @ bl + ah @ bh


def matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One TF32 pass: what a plain TF32 product would give."""
    return tf32(a) @ tf32(b)


def test_tf32_rounding_is_cvt_rna():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                      -(1.0 + 2 ** -11), 1.0 + 2 ** -12], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9,
                         -(1.0 + 2 ** -10), 1.0], dtype=torch.float32)
    got = tf32(x)
    assert torch.equal(got, want)
    # 10 explicit bits: every result has its 13 low mantissa bits clear
    assert int((got.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    hi, lo = split(torch.tensor([math.pi], dtype=torch.float32))
    assert abs(float(hi) + float(lo) - math.pi) < 2 ** -20


def _attention(q, k, v, heads, matmul):
    """attention_core's float32 path with both products through matmul."""
    n, s, e = q.shape
    dh = e // heads
    qh = (q * (1.0 / math.sqrt(dh))).reshape(n, s, heads, dh).transpose(1, 2)
    kh = k.reshape(n, s, heads, dh).transpose(1, 2)
    vh = v.reshape(n, s, heads, dh).transpose(1, 2)
    probs = torch.softmax(matmul(qh, kh.transpose(-1, -2)), dim=-1)
    return matmul(probs, vh).transpose(1, 2).reshape(n, s, e)


@pytest.fixture(scope="module")
def k1_case():
    """K1 at an LViT shape of the canonical model (S 256, E 96, 4 heads of
    24), 8 rows, and its float64 value."""
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(8, 256, 96).astype(np.float32))
               for _ in range(3))
    ref = _attention(q.double(), k.double(), v.double(), 4, torch.matmul)
    return q, k, v, ref


def _k1_within_tolerance(got, ref):
    return bool(torch.allclose(got.double(), ref, atol=K1_ATOL, rtol=K1_RTOL))


@pytest.mark.parametrize("route,meets", [("float32", True), ("tf32x3", True),
                                         ("tf32", False)])
def test_k1_lvit_shape_against_float64(k1_case, route, meets):
    q, k, v, ref = k1_case
    if route == "float32":
        got = cuda_attn.attention_core(q, k, v, 4)
    else:
        got = _attention(q, k, v, 4, matmul_tf32x3 if route == "tf32x3" else matmul_tf32)
    err = (got.double() - ref).abs().max().item()
    assert _k1_within_tolerance(got, ref) is meets, (route, err)
    if route == "tf32x3":   # as close as float32 itself, within a factor of 4
        plain = (cuda_attn.attention_core(q, k, v, 4).double() - ref).abs().max().item()
        assert err < 4 * plain + 1e-6, (err, plain)


def _strip_stats(o, t, cos_fn):
    """K5's row statistics (m, z) and column max K from cos_fn(o, t)."""
    cos = cos_fn(o[0], t[0].transpose(0, 1))
    cd = M._cdist(cos)
    m = cd.amin(dim=1)
    be = M._exp_term(cd, m[:, None])
    z = be.sum(dim=1)
    return m, z, (be / z[:, None]).amax(dim=0)


@pytest.fixture(scope="module")
def k5_case():
    """A K5 strip at relu3_1's width (C 256, 512 positions) where the
    generated features are near the target's (t = o + noise, normalised),
    as late in training: the row min m is about 1.5e-2 (against about 0.4
    for unrelated features), so 1/(m + 1e-5) magnifies an error in cos; and
    its float64 statistics.  (Much nearer, float32 itself cannot resolve
    cos near 1 to the bar.)"""
    rng = np.random.RandomState(1)
    o = rng.rand(1, 512, 256)
    t = o + 0.5 * rng.randn(1, 512, 256) * o.std()
    o, t = (x / np.linalg.norm(x, axis=-1, keepdims=True) for x in (o, t))
    o32, t32 = (torch.from_numpy(x.astype(np.float32)) for x in (o, t))
    ref = _strip_stats(o32.double(), t32.double(), torch.matmul)
    return o32, t32, ref


@pytest.mark.parametrize("route,meets", [("float32", True), ("tf32x3", True),
                                         ("tf32", False)])
def test_k5_strip_near_target_against_float64(k5_case, route, meets):
    o, t, ref = k5_case
    fn = {"float32": torch.matmul, "tf32x3": matmul_tf32x3, "tf32": matmul_tf32}[route]
    got = _strip_stats(o, t, fn)
    assert float(ref[0].median()) < 0.05   # the regime the bar is about
    ok = all(bool(torch.allclose(a.double(), b, rtol=STAT_RTOL, atol=STAT_ATOL))
             for a, b in zip(got, ref))
    errs = [((a.double() - b).abs() / b.abs().clamp_min(1e-12)).max().item()
            for a, b in zip(got, ref)]
    assert ok is meets, (route, errs)
