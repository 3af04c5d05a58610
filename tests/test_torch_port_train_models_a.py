"""The port's GanTrainer (cfen_vit_tpu_torch/train/trainer.py) against the
JAX package's for `--model decr_vit` and `decs_vit`: the ID-MRF loss set on
two branches (A and R, A and S) of the xdh specs, whose refined dh feeds
no loss.  The step and the bars are tests/torch_train_cases.py's
(model_step_tests)."""

from tests import torch_train_cases as C
from tests.torch_variant_cases import release_file_memory  # noqa: F401

MODELS = ("decr_vit", "decs_vit")
steps, test_model_step_matches_jax = C.model_step_tests(MODELS)
