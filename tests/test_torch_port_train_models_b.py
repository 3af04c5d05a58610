"""The port's GanTrainer (cfen_vit_tpu_torch/train/trainer.py) against the
JAX package's for `--model decn_vit` (the ID-MRF loss set on D alone) and
`vit` (MGVIT's four terms on ipt's one branch).  The step and the bars
are tests/torch_train_cases.py's (model_step_tests).  And the overfit
smoke (train/overfit.py) for a few steps on the CPU."""

import numpy as np

from tests import torch_train_cases as C
from tests.torch_variant_cases import release_file_memory  # noqa: F401

MODELS = ("decn_vit", "vit")


def test_overfit_smoke_runs_on_the_cpu():
    """cfen_vit_tpu_torch/train/overfit.py (the counterpart of
    scripts/train_overfit.py) on `--model vit` at 64 px for 3 steps: every
    step logged with finite losses and a PSNR, and the summary line.  It
    runs first, before the file's JAX steps are cached (its generator is
    at full width)."""
    from cfen_vit_tpu_torch.train import overfit
    hist = overfit.run("vit", steps=3, batch=2, size=64, pairs=2,
                       dtype="float32", remat=False, log_every=1,
                       gpu_ids="-1", quiet=True)
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(v) for h in hist for v in h.values())
    out = overfit.summary("vit", hist, 3)
    assert out["finished"] and out["steps"] == 3


steps, test_model_step_matches_jax = C.model_step_tests(MODELS)
