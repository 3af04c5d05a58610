"""Shared cases of the trainer parity tests (tests/test_torch_port_train*.py):
one JAX GanTrainer step and the port's from the same weights, at the
tiny geometry of tests/test_train.py (n_feats 8, loadSize 64, patch 8, 2
heads, batch 2, pool 4; a 128 px input for the half-res trunk, 64 px for
the full-res one), on the CPU.

The JAX trainer's state after its ActNorm init pass crosses into the port
through interop/from_jax.py (generator, discriminators, VGG); both take
one step on the same loader-style batch.  The bars: every loss term
within 1e-4 relative; the G and D grads (read from the first Adam
moments, which are (1 - beta1) g in both) within 1e-3 relative norm over
each network, and each tensor within 1e-2 relative norm plus 1e-6;
updated params within 2 lr + 1e-6 (Adam's first step moves a parameter by
about lr sign(g) wherever |g| >> eps, so the bound is set by lr, not by
the grad error).

Why the per-tensor bar is 1e-2 and not 1e-3: the JAX step itself, run on
one CPU device and on two (the same math summed in another order),
differs by up to 7.1e-3 in a tensor's relative norm at this batch (its
largest: the v3 generator's head.0.1.body.2.bias); the port is 3.5e-3
from JAX in its worst v3 tensor.  The biases that feed an InstanceNorm
have no gradient in exact math and hold only float noise (norms ~1e-7),
which the 1e-6 term covers.

Two float32 effects move a case past these bars on one CPU convolution
backend and not on the other.  A kink: a float32 step can put an
activation within rounding of a LeakyReLU, ReLU or max, where two
correct summation orders land on its two sides; at decs_vit, oneDNN's
convolutions leave one input of D_A's third LeakyReLU at 3.3e-7 on the
other side from JAX and from torch's own convolutions, and D_A's
first-layer grads then differ by 4.0e-3.  Float32 error: at the
accumulated v3 step, torch's own convolutions put the cotangent reaching
the D decoder's level-3 GViT (globalvit_decoder_03d, a 4x4 pooled map)
1.17e-2 off the port's float64 step, oneDNN 2.1e-3; that GViT's grads
are then 1.34e-2 off float64 on torch's own convolutions, 9.2e-4 on
oneDNN's and 9.8e-4 in JAX (`python -m tests.torch_train_precision`),
so the gap to JAX is float32 error, not a fault of the port.  So each
case states the CPU convolution backend (`onednn`) and the JAX device
layout (`jax_mesh`) it runs on; the bars are the same for all.

`jax_remat=False` takes the JAX step with remat off: the JAX remat only
re-traces the same math and costs compile time, while the port's step
keeps the CLI default (remat branch), so the port's checkpointed regions
are then held against JAX's plain step.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from cfen_vit_tpu import config as jax_config
from cfen_vit_tpu_torch import config as port_config
from cfen_vit_tpu_torch.interop.from_jax import (
    discriminator_state_dict_from_jax, state_dict_from_jax,
    vgg_state_dict_from_jax)
from tests.torch_variant_cases import release_memory

TINY = dict(n_feats=8, loadSize=64, patch_size=8, num_heads=2,
            hidden_dim_ratio=2, batchSize=2, pool_size=4, sb=True)
def cfg(mod, tmp_path, **kw):
    base = dict(dataroot=str(tmp_path), name="t", isTrain=True,
                checkpoints_dir=str(tmp_path / "ckpt"), **TINY)
    base.update(kw)
    return mod.Config(**base)


def u8_batch(seed, n=2, size=128):
    rng = np.random.RandomState(seed)
    b = {k: rng.randint(0, 256, (n, size, size, 1 if k == "S" else 3))
         .astype(np.float32) / 127.5 - 1.0 for k in "BARS"}
    b["B_paths"] = [f"x{i}.png" for i in range(n)]
    return b


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def step(tmp, model="dec_vit", jax_remat=True, jax_mesh="", onednn=True,
         **kw):
    """One JAX GanTrainer step and the port's, from the same weights;
    `kw` goes to both configs (batchSize, grad_accum, ...), `jax_mesh` to
    the JAX one's mesh_shape ("": the batch spread over the CPU devices),
    `onednn` False runs the port's step on torch's own CPU convolutions."""
    from cfen_vit_tpu.train.trainer import GanTrainer as JaxTrainer
    from cfen_vit_tpu_torch.train.trainer import GanTrainer

    mode = dict(model=model, dataset_mode="vit" if model == "vit"
                else "dec_vit", **kw)
    jcfg = cfg(jax_config, tmp, name="jax", remat=jax_remat,
               mesh_shape=jax_mesh, **mode)
    jtr = JaxTrainer(jcfg)
    jtr.setup(jcfg)
    size = 128 if jtr.spec.half_res_trunk else 64
    batch = u8_batch(0, n=jcfg.batchSize, size=size)
    jtr.set_input(batch)
    jtr.init_state({k: np.asarray(v) for k, v in jtr._batch.items()})
    before = np_tree({k: jtr.state[k] for k in ("g", "d")})
    vgg = np_tree(jtr.vgg)
    jtr.optimize_parameters(jcfg)
    after = np_tree({k: jtr.state[k]
                     for k in ("g", "d", "g_opt", "d_opt", "pools")})

    pcfg = cfg(port_config, tmp, name="port", **mode)
    ptr = GanTrainer(pcfg, torch.device("cpu"))
    spec = ptr.spec
    ptr.load_state_dicts(
        g=state_dict_from_jax(before["g"], spec),
        d={k: discriminator_state_dict_from_jax(v)
           for k, v in before["d"].items()},
        vgg=vgg_state_dict_from_jax(vgg))
    ptr.set_input(batch)
    with torch.backends.mkldnn.flags(enabled=onednn):
        ptr.optimize_parameters(pcfg)
    out = SimpleNamespace(ptr=ptr, spec=spec, after=after,
                          jlosses=jtr.get_current_losses(),
                          plosses=ptr.get_current_losses(), lr=jtr.lr)
    del jtr        # the JAX state and its executables: tier-1 runs six
    release_memory()   # workers at once, so a file keeps one step alive
    return out


def model_step_tests(models):
    """The module fixture and the test of a test_torch_port_train_models_*
    file: one JAX step and the port's per `--model` in `models` (JAX remat
    off, the port on torch's own CPU convolutions: the docstring above says
    why), cached while the file's tests for that model run, so one step is
    alive at a time; each case is one of check_losses (whose key sets are
    the JAX step's own), check_grads and check_params."""
    @pytest.fixture(scope="module")
    def steps(tmp_path_factory):
        cache = {}

        def get(model):
            if model not in cache:
                cache.clear()
                cache[model] = step(tmp_path_factory.mktemp(model), model,
                                    jax_remat=False, onednn=False)
            return cache[model]
        return get

    @pytest.mark.parametrize("check", ["losses", "grads", "params"])
    @pytest.mark.parametrize("model", models)
    def test_model_step_matches_jax(steps, model, check):
        _CHECKS[check](steps(model))
    return steps, test_model_step_matches_jax


def _moments(opt, module):
    return {name: opt.state[p]["exp_avg"]
            for name, p in module.named_parameters()}


def _pairs(s):
    """(name, port module, JAX params after the step, port first moments,
    JAX first moments) for G and every D."""
    after, ptr = s.after, s.ptr
    yield ("G", ptr.g, state_dict_from_jax(after["g"], s.spec),
           _moments(ptr.g_opt, ptr.g),
           state_dict_from_jax(after["g_opt"].mu, s.spec))
    d_mu = after["d_opt"].mu
    for k, d in ptr.d.items():
        yield (f"D_{k}", d, discriminator_state_dict_from_jax(after["d"][k]),
               _moments(ptr.d_opt, d),
               discriminator_state_dict_from_jax(d_mu[k]))


def check_losses(s):
    assert set(s.plosses) == set(s.jlosses)
    for k, ref in s.jlosses.items():
        assert abs(s.plosses[k] - ref) <= 1e-4 * abs(ref), (k, s.plosses[k],
                                                            ref)


def check_grads(s):
    n = 0
    for net, _, _, mom, ref_mom in _pairs(s):
        diffs, refs = [], []
        for name, m in mom.items():
            ref = ref_mom[name].double()
            err = (m.double() - ref).norm()
            assert err <= 1e-2 * ref.norm() + 1e-6, (net, name,
                                                     float(err / ref.norm()))
            diffs.append(err ** 2)
            refs.append(ref.norm() ** 2)
            n += 1
        assert (sum(diffs) / sum(refs)).sqrt() < 1e-3, net
    assert n == (len(list(s.ptr.g.parameters()))
                 + len(list(s.ptr.d.parameters())))


def check_params(s):
    bound = 2 * s.lr + 1e-6
    for net, module, ref_sd, _, _ in _pairs(s):
        for name, p in module.named_parameters():
            diff = (p.detach() - ref_sd[name]).abs().max().item()
            assert diff <= bound, (net, name, diff, bound)
        for name, buf in module.named_buffers():
            assert torch.equal(buf, ref_sd[name].reshape(buf.shape)), (net,
                                                                       name)


_CHECKS = {"losses": check_losses, "grads": check_grads, "params": check_params}
