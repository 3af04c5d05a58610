"""chip_smoke.py's phase-10 gate on the grads of one training step with
the kernels against the same step on the plain versions (`_grad_errors`),
on the CPU with made-up grads: it passes a copy off by float noise and a
tensor whose exact grad is zero (noise alone, under the floor), and it
fails a sign flip that keeps every norm, a wrong grad in one small tensor
that barely moves the norm of all of G (a stem weight, say), and one D
tensor of the wrong sign."""

import numpy as np
import pytest
import torch

import chip_smoke as S


def _grads(rng):
    """G: 40 tensors of unit-scale entries, a small stem weight, a bias
    whose exact grad is zero; D_A: 10 tensors."""
    g = {f"layer{i}.weight": rng.randn(50) for i in range(40)}
    g["head.0.0.weight"] = 0.05 / np.sqrt(50) * rng.randn(50)
    g["ds_conv_e02.0.bias"] = 1e-9 * rng.randn(8)
    d = {f"model.{i}.weight": rng.randn(30) for i in range(10)}
    return {net: {k: torch.from_numpy(v) for k, v in t.items()}
            for net, t in (("G", g), ("D_A", d))}


@pytest.mark.parametrize("fault, failing", [
    ("none", []), ("noise_bias", []), ("sign", ["G", "D_A"]),
    ("stem", ["G"]), ("d_tensor", ["D_A"])])
def test_trainer_grad_gate(fault, failing):
    rng = np.random.RandomState(0)
    want = _grads(rng)
    got = {net: {k: v * (1 + 1e-5 * torch.from_numpy(rng.randn(*v.shape)))
                 for k, v in t.items()} for net, t in want.items()}
    if fault == "noise_bias":
        got["G"]["ds_conv_e02.0.bias"] = -got["G"]["ds_conv_e02.0.bias"]
    elif fault == "sign":
        got = {net: {k: -v for k, v in t.items()} for net, t in got.items()}
    elif fault == "stem":
        got["G"]["head.0.0.weight"] = torch.from_numpy(
            rng.permutation(want["G"]["head.0.0.weight"].numpy()))
    elif fault == "d_tensor":
        got["D_A"]["model.3.weight"] = -got["D_A"]["model.3.weight"]
    out = S._grad_errors(got, want)
    assert [net for net, g in out.items() if not g["inside"]] == failing, out
    if fault == "stem":   # the network's norm alone would not see it
        assert out["G"]["relative"] < S.TRAINER_G_TOL
        assert out["G"]["worst_tensor"] == "head.0.0.weight"
