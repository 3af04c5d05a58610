"""Every `--model_G` spec of the port against the JAX plain path, group
1 of 3 (tests/torch_variant_cases.py: the geometry, the bar and the
checks)."""

import pytest

from tests import torch_variant_cases as C
from tests.torch_variant_cases import one_torch_thread  # noqa: F401

NAMES = C.GROUPS[0]


@pytest.fixture(scope="module")
def runs():
    return C.JaxRuns()


@pytest.mark.parametrize("name", NAMES)
def test_init_pass_matches_jax(runs, name):
    """Outputs of the ActNorm init pass and the statistics it leaves."""
    C.check_init_pass(runs[name])


@pytest.mark.parametrize("name", NAMES)
def test_second_pass_and_d_only_match_jax(runs, name):
    C.check_second_pass(runs[name])


@pytest.mark.parametrize("shape", [(2, 1, 1, 16), (2, 2, 3, 16), (1, 7, 5, 4)])
def test_resize_align_corners_matches_jax(rng, shape):
    """ops/resize.py resize_align_corners against the JAX refiner's
    _resize_align_corners, a 1x1 map (broadcast) among them."""
    import jax.numpy as jnp
    import numpy as np
    from cfen_vit_tpu.models.generator import _resize_align_corners
    from cfen_vit_tpu_torch.ops.resize import resize_align_corners
    x = rng.randn(*shape).astype(np.float32)
    want = np.asarray(_resize_align_corners(jnp.asarray(x), 32, 24))
    got = resize_align_corners(C.nchw(x), 32, 24).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("side,cin", [(32, 9), (64, 7)])
def test_spatial_pyramid_matches_jax(rng, side, cin):
    """The xdh refiner alone; at 32 px its 32x pool is one pixel, which the
    resize broadcasts."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from cfen_vit_tpu.models import generator as JG
    from cfen_vit_tpu_torch.interop.from_jax import _conv
    from cfen_vit_tpu_torch.models.generator import SpatialPyramid
    p = C.np_tree(JG.spatial_pyramid_init(jax.random.PRNGKey(4), cin))
    x = rng.uniform(-1, 1, (2, side, side, cin)).astype(np.float32)
    want = np.asarray(JG.spatial_pyramid_apply(p, jnp.asarray(x)))
    sp = SpatialPyramid(cin)
    sd = {}
    for name, conv in p.items():
        for k, v in _conv(conv).items():
            key = f"{name}.0.{k}" if name == "refine3" else f"{name}.{k}"
            sd[key] = torch.tensor(np.ascontiguousarray(v))
    sp.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = sp(C.nchw(x)).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, atol=1e-5)
