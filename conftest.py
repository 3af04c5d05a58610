"""What every pytest run of this repo selects, and how many torch threads a
pytest-xdist worker uses.  pytest loads this file for every test under the
repo, before `tests/conftest.py`, because pytest.ini sits beside it.
"""

import os

import pytest

if os.environ.get("PYTEST_XDIST_WORKER"):
    # One intra-op and one inter-op torch thread in each xdist worker:
    # torch's default pool of a thread a core in each of several workers
    # oversubscribes the cores, and one file's forwards then slow every
    # other worker's.  A single-process run keeps every core.  XLA's pool
    # and OMP_NUM_THREADS stay as they are (one XLA thread changes the
    # JAX reference's reduction order), and so does the environment of
    # the subprocesses tests start.
    import torch

    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    """Marks every `nightly` test `slow` too, before the mark plugin
    deselects by `-m`: a command line's `-m` replaces pytest.ini's
    `-m "not nightly"`, and `-m 'not slow'` then leaves the nightly tier
    out as well.  `-m nightly` still selects it."""
    for item in items:
        if item.get_closest_marker("nightly"):
            item.add_marker(pytest.mark.slow)
