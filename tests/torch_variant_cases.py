"""Shared cases of tests/test_torch_port_variants_*.py: every `--model_G`
spec of the port (cfen_vit_tpu_torch/models/generator.py) against the JAX
package's plain path, weight for weight, at the repository's tiny test
geometry (n_feats 8, loadSize 64, patch 8, 2 heads, hidden ratio 2; a
128 px input for the half-res trunk, 64 px for the full-res one).

JAX weights come from generator_init (uninitialised ActNorms) and its
ActNorm init pass, and cross to the port through interop/from_jax.py.
Bar: < 2e-4 in float32 on every output (the JAX package's own golden
bar), on the init pass, on a second forward, on the ActNorm statistics
the init pass leaves, and on the d-only fake_A.
"""

import ctypes
import gc
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cfen_vit_tpu.models import generator as JG
from cfen_vit_tpu.models import registry as JR
from cfen_vit_tpu_torch.interop.from_jax import state_dict_from_jax
from cfen_vit_tpu_torch.models import registry as TR
from cfen_vit_tpu_torch.models.generator import Generator

V3 = "iid_hlgvit_crs_gd4_cfs_v3"
TINY = dict(n_feats=8, load_size=64, patch_size=8, num_heads=2,
            hidden_dim_ratio=2)
BAR = 2e-4

# the 17 specs beside v3 (tests/test_torch_port_generator.py holds v3), in
# three files so that three workers share the JAX compiles
VARIANTS = sorted(n for n in JR._REGISTRY if n != V3)
GROUPS = (VARIANTS[0::3], VARIANTS[1::3], VARIANTS[2::3])


def release_memory():
    """Drops JAX's compiled programs and hands the freed heap back to the
    system: a worker keeps the high-water mark of every file it ran
    otherwise (a parity step's 2.7 GB stays at 2.7 GB after its objects
    are freed, and falls to 1.1 GB after malloc_trim), and the tier-1
    command's six workers share the machine's memory with the JAX
    package's largest files."""
    gc.collect()
    jax.clear_caches()
    ctypes.CDLL("libc.so.6").malloc_trim(0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while a file of these runs (each file imports this
    fixture): the tier-1 command runs six xdist workers, and a torch pool
    of one thread a core in each oversubscribes the cores, which made
    these tiny forwards five to ten times slower than alone.  The file's
    memory is released after it (`release_memory`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    release_memory()


def specs(name):
    """(JAX spec, port spec) of `name` at the tiny geometry."""
    return (replace(JR.generator_spec(name), **TINY),
            replace(TR.generator_spec(name), **TINY))


def side(spec) -> int:
    return spec.load_size * (2 if spec.half_res_trunk else 1)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_run(name, seed=7):
    """The JAX plain path of `name`: params before and after the ActNorm
    init pass on x0, and the outputs of that pass and of a second forward
    on x1."""
    spec, tspec = specs(name)
    p0 = JG.generator_init(jax.random.PRNGKey(seed), spec)
    rng = np.random.RandomState(0)
    x0, x1 = (rng.uniform(-1, 1, (2, side(spec), side(spec), 3))
              .astype(np.float32) for _ in range(2))
    # one compile for both passes: on initialised params the init pass
    # leaves every ActNorm as it is (JAX ops/nn.py actnorm_apply), so it is
    # the plain forward
    fwd = jax.jit(lambda p, x: JG.generator_forward(p, spec, x,
                                                    actnorm_init=True))
    out0, p1 = fwd(p0, jnp.asarray(x0))
    out1, _ = fwd(p1, jnp.asarray(x1))
    return SimpleNamespace(spec=spec, tspec=tspec, p0=np_tree(p0),
                           p1=np_tree(p1), x0=x0, x1=x1,
                           out0=np_tree(out0), out1=np_tree(out1))


class JaxRuns(dict):
    """Module-scoped cache: one JAX run per spec, shared by a file's
    tests (tier-1 runs a file on one worker)."""

    def __missing__(self, name):
        self[name] = jax_run(name)
        return self[name]


def port(ref, params) -> Generator:
    g = Generator(ref.tspec).eval()
    g.load_state_dict(state_dict_from_jax(params, ref.tspec), strict=True)
    return g


def assert_outputs(out, ref_out, keys=None):
    keys = sorted(ref_out) if keys is None else sorted(keys)
    assert sorted(out) == keys
    for k in keys:
        got = out[k].numpy().transpose(0, 2, 3, 1)
        assert got.shape == ref_out[k].shape, k
        diff = np.abs(got - ref_out[k]).max()
        assert diff < BAR, f"output {k}: {diff}"


def check_init_pass(ref) -> int:
    """The init pass from uninitialised ActNorms: outputs, then every
    ActNorm's statistics against the JAX params it leaves.  Returns the
    number of ActNorms."""
    g = port(ref, ref.p0)
    assert all(int(v) == 0 for k, v in g.state_dict().items()
               if k.endswith("initialized"))
    with torch.no_grad():
        out = g(nchw(ref.x0))
    assert_outputs(out, ref.out0)
    want, got = state_dict_from_jax(ref.p1, ref.tspec), g.state_dict()
    n_an = 0
    for k in want:
        if k.endswith("initialized"):
            n_an += 1
            assert int(got[k]) == 1, k
            base = k[: -len("initialized")]
            for part in ("weight", "bias"):
                np.testing.assert_allclose(
                    got[base + part].numpy(), want[base + part].numpy(),
                    atol=BAR, err_msg=base + part)
    return n_an


def check_second_pass(ref):
    """A forward with the initialised ActNorms, all outputs, then the
    d-only fake_A where the spec has D and another branch."""
    g = port(ref, ref.p1)
    with torch.no_grad():
        out = g(nchw(ref.x1))
        assert_outputs(out, ref.out1)
        if "d" in ref.tspec.branches and ref.tspec.branches != "d":
            assert_outputs(g(nchw(ref.x1), branches="d"), ref.out1, "d")
