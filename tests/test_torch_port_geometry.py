"""The shapes the v3 generator hands to K1, K3 and K4 at the JAX package's
geometries, against the port's wrappers' shape rules (no card needed).

The JAX package runs the v3 model at its default flags (n_feats 32,
hidden_dim_ratio 6, num_heads 4; cfen_vit_tpu/config.py) and its tests and
scripts at other widths and head counts.  For each, the geometry comes
from the JAX GenSpec (the port's GenSpec must agree), and every (head dim,
S) of the LViT and GViT blocks, the stem width and the tail width must be
taken by `cuda_attn.takes`, `cuda_stem.takes` and `cuda_tail.takes`: on
the card a wrapper raises on a shape it does not take.  One tiny CPU
forward checks that the derivation lists what the generator calls.
"""

import itertools
from dataclasses import replace

import numpy as np
import pytest
import torch

from cfen_vit_tpu.models.registry import generator_spec as jax_generator_spec
from cfen_vit_tpu_torch.models.generator import Generator, init_weights
from cfen_vit_tpu_torch.models.registry import generator_spec
from cfen_vit_tpu_torch.ops import cuda_attn, cuda_stem, cuda_tail

V3 = "iid_hlgvit_crs_gd4_cfs_v3"


def _spec(registry, n_feats, heads, load_size, **kw):
    return replace(registry(V3), n_feats=n_feats, num_heads=heads,
                   hidden_dim_ratio=6, load_size=load_size, **kw)


def _attention_shapes(spec):
    """(E, heads, S) of every ViT block of the v3 generator."""
    views = [spec.lvit_spec(lvl) for lvl in (1, 2, 3)]
    views += [spec.gvit_spec(lvl, encoder=enc) for lvl in (1, 2, 3)
              for enc in (True, False)]
    return {(v.embedding_dim, v.num_heads, v.seq_length) for v in views}


@pytest.mark.parametrize("load_size", [256, 512])
@pytest.mark.parametrize("n_feats,heads",
                         list(itertools.product((8, 16, 24, 32), (2, 4, 8))))
def test_kernels_take_every_v3_geometry(n_feats, heads, load_size):
    """n_feats 32, 4 heads is the JAX package's default: LViT head dim 32,
    GViT 128, a 16-channel stem and tails."""
    spec = _spec(jax_generator_spec, n_feats, heads, load_size)
    port = _spec(generator_spec, n_feats, heads, load_size)
    shapes = _attention_shapes(spec)
    assert _attention_shapes(port) == shapes
    for e, h, s in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            assert e % h == 0 and cuda_attn.takes(e // h, s, dtype), (e, h, s)
    c0 = spec.stem_channels()
    assert port.stem_channels() == c0
    assert cuda_stem.takes(3, c0), c0
    side = 2 * load_size            # the half-resolution trunk's image side
    for out_c in (spec.n_colors, 1):   # R and D tails, then S's
        assert cuda_tail.takes(c0, out_c, side, side), (c0, out_c)


@pytest.mark.parametrize("dh", [4, 6, 8, 12, 24, 32, 48, 96, 128, 192, 256])
def test_attention_takes_every_head_dim_at_long_sequences(dh):
    for s in (1, 17, 1024, 4096, 16384):
        for dtype in (torch.float32, torch.bfloat16):
            assert cuda_attn.takes(dh, s, dtype), (dh, s, dtype)


def test_attention_takes_every_head_dim_in_both_dtypes():
    """K1 (and K2's attention) take every head dim: up to 256 in the
    instantiated widths, wider ones streamed in chunks, an odd bf16 one
    as a copy padded to even (whose head stride is then dh + 1)."""
    for dh in range(1, 513):
        for dtype in (torch.float32, torch.bfloat16):
            assert cuda_attn.takes(dh, 256, dtype), (dh, dtype)
            assert cuda_attn.takes(dh, 1, dtype), (dh, dtype)
        assert cuda_attn.head_stride(dh, torch.float32) == dh
        assert cuda_attn.head_stride(dh, torch.bfloat16) == dh + dh % 2


def test_what_still_raises_is_named():
    """K1 refuses an empty head or sequence; K3 takes out_c 1 or 3 only,
    K4 an RGB input into 1 to MAX_STEM_WIDTH channels."""
    for dtype in (torch.float32, torch.bfloat16):
        assert not cuda_attn.takes(0, 256, dtype)
        assert not cuda_attn.takes(64, 0, dtype)
    assert not cuda_tail.takes(16, 2, 512, 512)
    assert not cuda_stem.takes(4, 16)
    assert [cm for cm in range(1, 147) if not cuda_stem.takes(3, cm)] == []
    assert not cuda_stem.takes(3, cuda_stem.MAX_STEM_WIDTH + 1)


def test_derived_shapes_are_what_the_generator_calls(monkeypatch):
    """One tiny CPU forward (n_feats 8, 2 heads) with the three dispatchers
    wrapped: the (E, heads, S), stem and tail widths they see are the ones
    derived from the spec above."""
    spec = _spec(generator_spec, 8, 2, 64, patch_size=8)
    seen = {"attention": set(), "stem": set(), "tail": set()}

    def wrap(mod, name, record):
        fn = getattr(mod, name)

        def recorded(*args):
            seen[record[0]].add(record[1](*args))
            return fn(*args)
        monkeypatch.setattr(mod, name, recorded)
    wrap(cuda_attn, "block_attention",
         ("attention", lambda q, k, v, h: (q.shape[2], h, q.shape[1])))
    wrap(cuda_stem, "fused_stem", ("stem", lambda x, w5, *_: w5.shape[0]))
    wrap(cuda_tail, "tail_epilogue",
         ("tail", lambda t2, w, b: (t2.shape[1], w.shape[0])))
    net = init_weights(Generator(spec), torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(np.random.RandomState(0).uniform(
        -1, 1, (1, 3, 128, 128)).astype(np.float32))
    with torch.no_grad():
        net(x)
    assert seen["attention"] == _attention_shapes(spec)
    c0 = spec.stem_channels()
    assert seen["stem"] == {c0}
    assert seen["tail"] == {(c0, 3), (c0, 1)}
