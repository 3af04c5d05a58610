"""Every `--model_G` spec of the port against the JAX plain path, group
2 of 3 (tests/torch_variant_cases.py: the geometry, the bar and the
checks)."""

import pytest

from tests import torch_variant_cases as C
from tests.torch_variant_cases import release_file_memory  # noqa: F401

NAMES = C.GROUPS[1]


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
