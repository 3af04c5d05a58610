"""The implicit-GEMM orderings of K3 (csrc/tail.cu) and K4 (csrc/stem.cu),
emulated in torch on the CPU and held against the JAX package.

The kernels run their convolutions as products of M output positions by
K (tap, input channel) by N output channels, with the channels padded to
the k step and N padded to 8: K3's bf16 path takes the input in chunks of
16 channels, tap-major inside a chunk, against out_c padded to 8; K4's two
3x3 convs take K = 9 taps x cpad, tap-major, cpad being cm rounded up to
16 (bf16) or 8 (float32), against N chunks of 8 NT channels.  K4's head
conv is FFMA over its weights staged as [75][8 NT], k = (c, dy, dx) summed
in order.  The weight packers below index the weights as the kernels'
staging loops do (`tail_mma_kernel`'s and `stem_kernel`'s `stage`), and
every padded slot is zero.  In float32 the emulation is held against the
JAX plain functions (`_tail_epilogue_plain`, `_stem_plain`) to 3e-5, the
summation order being the only difference.  K4's 3x3 products run as
3xTF32 in float32: the split over their K meets chip_smoke.py's float32
tolerance against float64, and one TF32 pass does not (the TF32 emulation
of tests/test_torch_port_tf32_split.py).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cfen_vit_tpu.models.generator import _stem_plain, _tail_epilogue_plain
from tests.test_torch_port_tf32_split import matmul_tf32, matmul_tf32x3

TOL = 3e-5
K_ATOL, K_RTOL = 1e-4, 1e-5   # chip_smoke.py TOL["float32"]
CHUNK = 16                    # K3's channels a chunk (tail.cu kCC)
HEAD_K = 75                   # K4's head conv (stem.cu kHeadK)


def _round_up(v, m):
    return -(-v // m) * m


def _patches(x, k, pad, mode):
    """[B, C, H, W] -> [B, H, W, C, k*k]: the k x k window of each output
    position, padded as the convolution pads."""
    xp = F.pad(x, (pad,) * 4, mode=mode)
    b, c, h, w = x.shape
    cols = F.unfold(xp, k)                          # [B, C*k*k, H*W]
    return cols.view(b, c, k * k, h, w).permute(0, 3, 4, 1, 2)


def _a_tap_major(x, k, pad, mode, cpad):
    """A [B*H*W, k*k*cpad]: (tap, channel) with the channels padded."""
    p = _patches(x, k, pad, mode)                   # [B, H, W, C, taps]
    b, h, w, c, taps = p.shape
    p = F.pad(p, (0, 0, 0, cpad - c))               # channels to cpad
    return p.permute(0, 1, 2, 4, 3).reshape(b * h * w, taps * cpad)


def pack_tail_chunk(w, c0):
    """tail.cu wt for the chunk at channel c0: [8][49*16], [n][tap*16 + c]
    = w[n, c0 + c, tap], zero past out_c and past the input width."""
    out_c, cin = w.shape[:2]
    live = min(CHUNK, cin - c0)
    bt = torch.zeros(8, 49, CHUNK, dtype=w.dtype)
    bt[:out_c, :, :live] = w[:, c0:c0 + live].reshape(out_c, live, 49).transpose(1, 2)
    return bt.view(8, 49 * CHUNK)


def pack_3x3(w, cpad, n0, nt):
    """stem.cu stage for a 3x3 conv: [8 nt][9 cpad], [n][tap*cpad + c] =
    w[n0 + n, c, tap], zero past cm in n and c."""
    cm = w.shape[0]
    rows = min(8 * nt, cm - n0)
    bt = torch.zeros(8 * nt, 9, cpad, dtype=w.dtype)
    bt[:rows, :, :cm] = w[n0:n0 + rows].reshape(rows, cm, 9).transpose(1, 2)
    return bt.view(8 * nt, 9 * cpad)


def pack_head(w5, n0, nt):
    """stem.cu stage for the head conv: [75][8 nt], [k][n] = w5[n0 + n]
    flattened in its (c, dy, dx) order, zero past cm."""
    cm = w5.shape[0]
    bt = torch.zeros(HEAD_K, 8 * nt, dtype=w5.dtype)
    rows = min(8 * nt, cm - n0)
    bt[:, :rows] = w5[n0:n0 + rows].reshape(rows, HEAD_K).t()
    return bt


def _head_ordered(a, bt):
    """K4's head FFMA: each sum over k = (c, dy, dx) in order from zero."""
    acc = torch.zeros(a.shape[0], bt.shape[1], dtype=a.dtype)
    for k in range(HEAD_K):
        acc = acc + a[:, k:k + 1] * bt[k]
    return acc


def tail_igemm(t2, w, b, matmul=torch.matmul):
    """K3's bf16 ordering in any dtype: chunks of 16 channels, tap-major
    inside, N padded to 8; then tanh(sum + bias) on the live columns."""
    bsz, cin, h, wd = t2.shape
    out_c = w.shape[0]
    acc = torch.zeros(bsz * h * wd, 8, dtype=t2.dtype)
    for c0 in range(0, cin, CHUNK):
        a = _a_tap_major(t2[:, c0:c0 + CHUNK], 7, 3, "reflect", CHUNK)
        acc = acc + matmul(a, pack_tail_chunk(w, c0).t())
    assert not acc[:, out_c:].any()   # the padded columns stay zero
    out = torch.tanh(acc[:, :out_c] + b)
    return out.view(bsz, h, wd, out_c).permute(0, 3, 1, 2)


def _conv_igemm(a, pack, cm, nt, matmul):
    """The N chunks of 8 nt channels of one conv, as the kernel sweeps
    them, concatenated to [M, cm]."""
    cols = [matmul(a, pack(n0).t()) for n0 in range(0, cm, 8 * nt)]
    return torch.cat(cols, dim=1)[:, :cm]


def stem_igemm(x, w5, b5, w1, b1, w2, b2, kstep, nt, matmul=torch.matmul):
    """K4's ordering: the head conv summed over k = (c, dy, dx) in order,
    the 3x3 convs tap-major over cpad = cm rounded up to kstep through
    matmul; h and r1 zero outside the image (the 3x3 convs' zero
    padding)."""
    bsz, _, h, wd = x.shape
    cm = w5.shape[0]
    cpad = _round_up(cm, kstep)

    def nchw(m):
        return m.view(bsz, h, wd, cm).permute(0, 3, 1, 2)

    a = _patches(x, 5, 2, "constant").reshape(bsz * h * wd, HEAD_K)
    heads = [_head_ordered(a, pack_head(w5, n0, nt)) for n0 in range(0, cm, 8 * nt)]
    hm = torch.cat(heads, dim=1)[:, :cm] + b5
    r1 = _conv_igemm(_a_tap_major(nchw(hm), 3, 1, "constant", cpad),
                     lambda n0: pack_3x3(w1, cpad, n0, nt), cm, nt, matmul) + b1
    r1 = torch.relu(r1)
    out = _conv_igemm(_a_tap_major(nchw(r1), 3, 1, "constant", cpad),
                      lambda n0: pack_3x3(w2, cpad, n0, nt), cm, nt, matmul) + b2
    return nchw(hm + out)


def _jax_conv(w, b):
    """A torch [out, in, k, k] conv as the JAX package's HWIO params."""
    return {"w": jnp.asarray(w.numpy().transpose(2, 3, 1, 0)), "b": jnp.asarray(b.numpy())}


def _nhwc(t):
    return jnp.asarray(t.numpy().transpose(0, 2, 3, 1))


def _torch(a):
    return torch.from_numpy(np.asarray(a).transpose(0, 3, 1, 2).copy())


def _stem_weights(rng, cm, dtype=np.float32):
    def rn(*shape, std):
        return torch.from_numpy((rng.randn(*shape) * std).astype(dtype))
    std3 = math.sqrt(2 / (9 * cm))
    return [rn(cm, 3, 5, 5, std=math.sqrt(2 / 75)), rn(cm, std=0.1),
            rn(cm, cm, 3, 3, std=std3), rn(cm, std=0.1),
            rn(cm, cm, 3, 3, std=std3), rn(cm, std=0.1)]


@pytest.mark.parametrize("out_c", [3, 1])
@pytest.mark.parametrize("cin", [1, 12, 24, 33])
def test_tail_ordering_matches_jax_plain(rng, cin, out_c):
    t2 = torch.from_numpy(np.maximum(rng.randn(1, cin, 16, 24), 0).astype(np.float32))
    w = torch.from_numpy((rng.randn(out_c, cin, 7, 7) * math.sqrt(2 / (49 * cin)))
                         .astype(np.float32))
    b = torch.from_numpy((rng.randn(out_c) * 0.1).astype(np.float32))
    got = tail_igemm(t2, w, b)
    want = _tail_epilogue_plain(_nhwc(t2), _jax_conv(w, b))
    np.testing.assert_allclose(got.numpy(), _torch(want).numpy(), atol=TOL)


@pytest.mark.parametrize("kstep,nt", [(16, 2), (8, 1), (8, 3), (16, 4)])
@pytest.mark.parametrize("cm", [1, 12, 24, 146])
def test_stem_ordering_matches_jax_plain(rng, cm, kstep, nt):
    """kstep 16 is the bf16 cpad, 8 the float32 one; nt the N chunk's n8
    tiles (1-4 as stem_plan chooses by shared memory)."""
    x = torch.from_numpy(rng.uniform(-1, 1, (1, 3, 16, 24)).astype(np.float32))
    ws = _stem_weights(rng, cm)
    got = stem_igemm(x, *ws, kstep=kstep, nt=nt)
    head = {"conv": _jax_conv(ws[0], ws[1]),
            "res": {"c1": _jax_conv(ws[2], ws[3]), "c2": _jax_conv(ws[4], ws[5])}}
    want = _stem_plain(_nhwc(x), head)
    np.testing.assert_allclose(got.numpy(), _torch(want).numpy(), atol=TOL)


@pytest.mark.parametrize("cm", [12, 16])
@pytest.mark.parametrize("route,meets", [("tf32x3", True), ("tf32", False)])
def test_stem_float32_split_against_float64(rng, cm, route, meets):
    """K4 in float32 at the canonical (12) and the defaults' (16) stem
    widths, over a 32 x 32 image: the 3x3 convs' products as 3xTF32 stay
    within the card's float32 tolerance of the float64 stem; one TF32
    pass does not."""
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32))
    ws = _stem_weights(rng, cm)
    ref = stem_igemm(x.double(), *(w.double() for w in ws), kstep=8, nt=2)
    matmul = matmul_tf32x3 if route == "tf32x3" else matmul_tf32
    got = stem_igemm(x, *ws, kstep=8, nt=2, matmul=matmul)
    err = (got.double() - ref).abs().max().item()
    ok = bool(torch.allclose(got.double(), ref, atol=K_ATOL, rtol=K_RTOL))
    assert ok is meets, (route, err)
