"""Which float32 step is closer to exact math: the G grads of one training
step of the JAX package and of the port (on torch's own CPU convolutions
and on oneDNN's), each held against the port's same step in float64, at
the tiny geometry of tests/torch_train_cases.py (one CPU thread).  Also
the cotangent that reaches the output of MODULE, the D decoder's level-3
GViT, against float64.

It explains the CPU convolution backend a parity case of
tests/torch_train_cases.py runs on: where one float32 run is off the
float64 grads by more than the others, its gap to JAX is float32 error,
not a fault of the port.

With `--kinks` it lists instead the ReLU, LeakyReLU and abs inputs that
the two CPU convolution backends put on different sides of 0 in one
whole port step.

    python -m tests.torch_train_precision             # --grad_accum 2, v3, batch 4
    python -m tests.torch_train_precision --model decs_vit --batch 2 \
        --accum 1 --kinks

Not a test: it runs one JAX step and three port steps (about 8 minutes on
one CPU thread)."""

import argparse
import gc
import pathlib
import tempfile

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.overrides import TorchFunctionMode  # noqa: E402

from cfen_vit_tpu import config as jax_config  # noqa: E402
from cfen_vit_tpu.train.trainer import GanTrainer as JaxTrainer  # noqa: E402
from cfen_vit_tpu_torch import config as port_config  # noqa: E402
from cfen_vit_tpu_torch.interop.from_jax import (  # noqa: E402
    discriminator_state_dict_from_jax, state_dict_from_jax,
    vgg_state_dict_from_jax)
from cfen_vit_tpu_torch.train.trainer import GanTrainer  # noqa: E402
from tests import torch_train_cases as C  # noqa: E402

MODULE = "globalvit_decoder_03d"


def _trainer(tmp, mode, before, vgg, batch):
    """The port's trainer on the JAX trainer's weights, its ActNorm init
    pass made (in float32, as the step makes it)."""
    tr = GanTrainer(C.cfg(port_config, tmp, name="port", **mode),
                    torch.device("cpu"))
    tr.load_state_dicts(
        g=state_dict_from_jax(before["g"], tr.spec),
        d={k: discriminator_state_dict_from_jax(v)
           for k, v in before["d"].items()},
        vgg=vgg_state_dict_from_jax(vgg))
    tr.set_input(batch)
    with torch.no_grad():
        tr.g(tr._batch["B"])
    return tr


class _KinkInputs(TorchFunctionMode):
    """Keeps the input of every ReLU, LeakyReLU and abs a step calls."""
    FUNCS = {F.relu: "relu", torch.relu: "relu", F.leaky_relu: "leaky_relu",
             torch.abs: "abs", torch.Tensor.abs: "abs"}

    def __init__(self):
        super().__init__()
        self.inputs = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.FUNCS:
            self.inputs.append((self.FUNCS[func], args[0].detach().clone()))
        return func(*args, **(kwargs or {}))


def _kink_flips(run):
    """One whole port step (G and D) on each CPU convolution backend:
    every kinked op whose input lies on one side of 0 on one backend and
    on the other side on the other, with the two values."""
    inputs = {}
    for onednn in (False, True):
        tr = _trainer(*run)
        rec = _KinkInputs()
        with torch.backends.mkldnn.flags(enabled=onednn), rec:
            tr.optimize_parameters()
        inputs[onednn] = rec.inputs
    for i, ((name, a), (_, b)) in enumerate(zip(inputs[False], inputs[True])):
        flip = ((a > 0) != (b > 0)).nonzero().tolist()
        for j in flip[:4]:
            print(f"op {i} {name} {tuple(a.shape)} at {j}: torch's own "
                  f"{float(a[tuple(j)]):.3g}, oneDNN {float(b[tuple(j)]):.3g}",
                  flush=True)


def _port_g_grads(tmp, mode, before, vgg, batch, onednn, dtype):
    """The port's G grads of one step (the mean over the micro-batches of
    the G loss), in `dtype`, and the cotangents reaching MODULE's output
    in the order its backward calls take them."""
    tr = _trainer(tmp, mode, before, vgg, batch)
    tr.g.to(dtype)
    tr.d.to(dtype)
    tr.vgg.to(dtype)
    tr.dtype = dtype
    cots = []

    def keep(mod, args, out):
        if out.requires_grad:
            out.register_hook(lambda g: cots.append(g.detach().double()))
    hook = getattr(tr.g, MODULE).register_forward_hook(keep)
    n, mb = tr.accum, mode["batchSize"] // tr.accum
    with torch.backends.mkldnn.flags(enabled=onednn):
        for i in range(n):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in tr._batch.items()}
            losses, _, _ = tr._g_loss(tr.g, part)
            (losses["G"] / n).backward(inputs=list(tr.g.parameters()))
    hook.remove()
    return {k: p.grad.double() for k, p in tr.g.named_parameters()}, cots


def _against(tag, grads, ref):
    """Relative norm over G, the worst tensor past the tests' 1e-6 floor,
    and the worst of MODULE's tensors."""
    err = {k: float((grads[k].reshape(r.shape) - r).norm()) for k, r in ref.items()}
    norm = {k: float(r.norm()) for k, r in ref.items()}
    total = sum(e * e for e in err.values()) ** 0.5 / sum(
        n * n for n in norm.values()) ** 0.5
    worst = max(ref, key=lambda k: (err[k] - 1e-6) / max(norm[k], 1e-30))
    mod = max((k for k in ref if k.startswith(MODULE + ".")),
              key=lambda k: err[k] / max(norm[k], 1e-30))
    print(f"{tag} against float64: G {total:.3g}; worst tensor {worst} "
          f"{err[worst] / norm[worst]:.3g}; worst of {MODULE} {mod} "
          f"{err[mod] / norm[mod]:.3g}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="dec_vit")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--accum", type=int, default=2)
    ap.add_argument("--kinks", action="store_true",
                    help="list the kinks the two CPU backends take on "
                    "different sides, in place of the float64 comparison")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="precision_"))
    mode = dict(model=args.model, dataset_mode="vit" if args.model == "vit"
                else "dec_vit", batchSize=args.batch, grad_accum=args.accum)
    jcfg = C.cfg(jax_config, tmp, name="jax", remat=False, mesh_shape="1",
                 **mode)
    jtr = JaxTrainer(jcfg)
    jtr.setup(jcfg)
    batch = C.u8_batch(0, n=args.batch,
                       size=128 if jtr.spec.half_res_trunk else 64)
    jtr.set_input(batch)
    jtr.init_state({k: np.asarray(v) for k, v in jtr._batch.items()})
    before = C.np_tree({k: jtr.state[k] for k in ("g", "d")})
    vgg = C.np_tree(jtr.vgg)
    jtr.optimize_parameters(jcfg)
    # Adam's first moment after one step is (1 - beta1) g
    jax_g = {k: torch.as_tensor(np.asarray(v)).double() / (1 - jcfg.beta1)
             for k, v in state_dict_from_jax(
                 C.np_tree(jtr.state["g_opt"]).mu, jtr.spec).items()}
    del jtr
    gc.collect()
    jax.clear_caches()

    run = (tmp, mode, before, vgg, batch)
    if args.kinks:
        return _kink_flips(run)
    ref, ref_cots = _port_g_grads(*run, False, torch.float64)
    _against("JAX (one CPU device)", jax_g, ref)
    for tag, onednn in (("port, torch's own convolutions", False),
                        ("port, oneDNN", True)):
        grads, cots = _port_g_grads(*run, onednn, torch.float32)
        _against(tag, grads, ref)
        rel = [float((c - r).norm() / r.norm()) for c, r in zip(cots, ref_cots)]
        print(f"  cotangent at {MODULE}'s output against float64, per "
              f"backward call: {[f'{r:.3g}' for r in rel]}", flush=True)


if __name__ == "__main__":
    main()
