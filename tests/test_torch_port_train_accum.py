"""`--grad_accum 2` in the port's GanTrainer (cfen_vit_tpu_torch/train/
trainer.py) against the JAX package's accumulated step (its lax.scan over
micro-batches, cfen_vit_tpu/train/trainer.py grads_and_pools): the v3
generator at batch 4 in two micro-batches of 2, one step from the same
weights.  Losses (the means over micro-batches, ID-MRF's sum-normalised
term scaled by 1/2 in both), grads and params at the bars of
tests/torch_train_cases.py, and the pools, which take all 4 images.  The
port runs on oneDNN's CPU convolutions, the backend whose float32 step is
closer to float64 here (tests/torch_train_cases.py says why)."""

import pytest

from tests import torch_train_cases as C
from tests.torch_variant_cases import release_file_memory  # noqa: F401


@pytest.fixture(scope="module")
def accum_step(tmp_path_factory):
    return C.step(tmp_path_factory.mktemp("accum"), "dec_vit",
                  jax_remat=False, jax_mesh="1", batchSize=4, grad_accum=2)


@pytest.mark.parametrize("check", ["losses", "grads", "params"])
def test_accumulated_step_matches_jax(accum_step, check):
    assert accum_step.ptr.accum == 2
    getattr(C, f"check_{check}")(accum_step)


def test_accumulated_step_pools_take_the_whole_batch(accum_step):
    s = accum_step
    assert sorted(s.ptr.pools) == sorted(s.after["pools"]) == ["A", "R", "S"]
    for name, pool in s.ptr.pools.items():
        assert pool["n"] == int(s.after["pools"][name]["n"]) == 4, name
