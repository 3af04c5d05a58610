"""The benchmark's operation and byte counts against hand arithmetic."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.counts import flops
from benchmark.counts.kernels import attention_work, mrf_calls
from benchmark.counts.peaks import PEAK_FLOPS, least_s
from benchmark.reference.nets import ViT, ViTSpec, gen_spec
from benchmark.tests.tiny import SWITCHES


def test_vit_block_flops():
    """One LViT block on n tiles of s tokens of width e, hidden h: the
    linear encoding (e x e), q, k, v and out (4 e x e), QK^T and PV
    (2 s^2 e), the MLP (2 e h) and the head (2 e h), two FLOPs a
    multiply-add."""
    spec = ViTSpec(img_dim=32, patch_dim=2, num_channels=24, embedding_dim=96,
                   num_heads=4, hidden_dim=384)
    n, s, e, h = 8, 256, 96, 384
    with torch.device("meta"):
        vit = ViT(spec)
        t = torch.empty(n, s, e)
    with FlopCounterMode(display=False) as fc:
        vit.tokens(t)
    want = 2 * n * (5 * s * e * e + 2 * s * s * e + 4 * s * e * h)
    assert fc.get_total_flops() == want


def test_attention_and_mrf_work():
    assert attention_work(8, 256, 96, 2) == (4.0 * 8 * 256 ** 2 * 96,
                                             4.0 * 8 * 256 * 96 * 2)
    calls = mrf_calls(4, 512, 4)
    assert len(calls) == 6
    p3, p4 = 128 ** 2, 64 ** 2
    assert calls[0] == (2.0 * 4 * p3 ** 2 * 256, 2.0 * 4 * p3 * 256 * 4 + 4 * p3 * 28)
    assert calls[1] == calls[2] == (4.0 * 4 * p3 ** 2 * 256,
                                    3.0 * 4 * p3 * 256 * 4 + 4 * p3 * 28)
    assert calls[3][0] == 2.0 * 4 * p4 ** 2 * 512


def test_least_time():
    assert least_s(989e12, 0, "bfloat16") == 1.0
    assert least_s(0, 3.35e12, "float32") == 1.0
    assert PEAK_FLOPS["float32"] == 165e12


def test_unit_counts_see_every_attention_call():
    """A d-only v3 forward runs the encoder's 6 blocks, R's and S's levels
    3 and 2 (4 each) and D's 6: 20 attention calls."""
    v3 = "iid_hlgvit_crs_gd4_cfs_v3"
    spec = gen_spec(v3, SWITCHES[v3], n_feats=8, patch_size=8,
                    num_heads=2, hidden_dim_ratio=2, load_size=64)
    d_only = flops.infer_unit(spec, 2, 128, "d")
    full = flops.infer_unit(spec, 2, 128, None)
    assert len(d_only["attention"]) == 20 and len(full["attention"]) == 24
    assert 0 < d_only["flops"] < full["flops"]
    assert d_only["attention"][0] == (2 * 64, 16, 32)   # level-1 tiles
