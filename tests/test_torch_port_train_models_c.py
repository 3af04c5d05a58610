"""The port's GanTrainer (cfen_vit_tpu_torch/train/trainer.py) against the
JAX package's for `--model dec_mgvit`: DECMGVIT's loss set on dec_ipt's
three outputs, whose A is the SpatialPyramid-refined dh, so the refiner is
on the grad path.  The step and the bars are tests/torch_train_cases.py's
(model_step_tests)."""

from tests import torch_train_cases as C
from tests.torch_variant_cases import release_file_memory  # noqa: F401

MODELS = ("dec_mgvit",)
steps, test_model_step_matches_jax = C.model_step_tests(MODELS)
