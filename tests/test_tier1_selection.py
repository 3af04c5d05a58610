"""What the repo's root conftest.py decides for every run: which tests a
marker expression selects, and how many torch threads an xdist worker
uses.

The tier-1 command passes `-m 'not slow'`, which replaces pytest.ini's
`-m "not nightly"`; the conftest's collection hook marks every nightly
test slow as well, so that the nightly tier stays out of that run and
still runs under `-m nightly`.  The selection is read from a
`--collect-only` run of pytest in a subprocess, over the two files whose
every case is nightly.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NIGHTLY_FILES = ("tests/test_nightly_full_geometry.py",
                 "tests/test_train_overfit.py")


def collected(*marks):
    """Node ids that `pytest --collect-only` selects from NIGHTLY_FILES
    with the extra options `marks`."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTEST_XDIST")}
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q",
         "-p", "no:cacheprovider", *marks, *NIGHTLY_FILES],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, timeout=120)
    # 5: every collected test was deselected
    assert proc.returncode in (0, 5), proc.stdout[-3000:]
    return {line for line in proc.stdout.splitlines() if "::" in line}


def test_not_slow_leaves_nightly_out():
    """The tier-1 command's `-m 'not slow'` selects no nightly case."""
    assert collected("-m", "not slow") == set()


def test_nightly_selects_both_files():
    """`-m nightly` selects every case of both files: all that an empty
    marker expression collects there."""
    every = collected("-m", "")
    assert {i.split("::")[0] for i in every} == set(NIGHTLY_FILES), every
    assert collected("-m", "nightly") == every


def test_xdist_worker_has_one_torch_thread():
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        pytest.skip("not a pytest-xdist worker: a single-process run keeps "
                    "torch's default threads")
    import torch

    assert torch.get_num_threads() == 1
    assert torch.get_num_interop_threads() == 1
