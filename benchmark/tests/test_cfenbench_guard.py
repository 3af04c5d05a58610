"""The run's check that nothing loaded JAX or the JAX package, compared
by whole top-level module names."""

import subprocess
import sys

from benchmark.run import ROOT, forbidden_modules


def test_port_passes_and_jax_package_fails():
    assert forbidden_modules({"cfen_vit_tpu_torch": 1,
                              "cfen_vit_tpu_torch.ops": 1,
                              "jaxtyping": 1, "flaxen": 1}) == []
    assert forbidden_modules({"cfen_vit_tpu": 1, "cfen_vit_tpu.models": 1,
                              "jax.numpy": 1, "jaxlib": 1, "flax": 1}) == [
        "cfen_vit_tpu", "cfen_vit_tpu.models", "flax", "jax.numpy", "jaxlib"]


def test_harness_and_port_load_no_jax():
    """A fresh interpreter that imports the harness, its loops and the
    port's modules the loops use finds nothing forbidden."""
    code = ("import benchmark.run as r, benchmark.loops.infer_closed, "
            "benchmark.loops.train_closed, benchmark.calibrate\n"
            "import cfen_vit_tpu_torch.models.dehazing_model, "
            "cfen_vit_tpu_torch.train.trainer\n"
            "print(r.forbidden_modules())")
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": ""}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
