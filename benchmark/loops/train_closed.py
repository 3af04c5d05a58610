"""Closed-loop training: one GanTrainer (the port's train/trainer.py, as
`create_model` builds it for the train CLI) steps through a pool of
distinct batches, one after another.

Set-up builds the trainer, hands it weights drawn from the seed on the
device (reference/weights.py), makes the pool (loops/hazy.py, in the data
loader's format: NHWC float32 in [-1, 1], uint8-recoverable, S its
1-channel luma) and drives the trainer through its first `checked_steps`
steps on pool batches 0, 1, 2 with the window's own call; those steps
warm every shape, take the ActNorm init pass, and are what the plain
reference follows once the window has closed.  The window then steps on
through the pool (batch 3, 4, ... cycling) for `seconds`, and ends with a
torch.cuda.synchronize(): train_step_ms is its wall time over its steps.
A step the skip gate refuses, or that raises, is failed.

Once the window has closed and the peak is read, the trainer's state
(G, the Ds, every Adam moment and step count) is copied and the trainer
takes one more step through the same call on the next pool batch: the
reference takes that step too from the copied state, so a step of the
timed path after warm-up is held against it as well as the first three.
"""

from __future__ import annotations

import gc
import time

import torch

from .. import check
from ..counts import flops as count_flops
from ..counts.kernels import mrf_calls
from ..counts.peaks import ITEM_BYTES
from ..reference.losses import VGG19
from ..reference.step import RefTrainer, branch_names
from ..reference.weights import draw, draw_all, stream_seed
from ..trace import Window
from . import hazy
from .common import plain, program_config, ref_spec, stage, sync


def make_pool(config: dict, mix: dict, seed: int, device) -> list:
    """`pool_batches` batches of {B, A, R, S} as host float32 NHWC."""
    n, side = mix["pool_batches"] * mix["batch"], config["image_side"]
    sc = hazy.scenes(n, side, seed, device)
    arrays = {"B": hazy.loader_floats(sc["hazy"]),
              "A": hazy.loader_floats(sc["clear"]),
              "R": hazy.loader_floats(sc["clear"]),
              "S": hazy.loader_floats(sc["t"], grey=True)}
    arrays = {k: v.cpu().numpy() for k, v in arrays.items()}
    b = mix["batch"]
    return [{k: v[i * b:(i + 1) * b] for k, v in arrays.items()}
            for i in range(mix["pool_batches"])]


def program_leaves(trainer) -> dict:
    out = {f"G.{k}": p for k, p in trainer.g.named_parameters()}
    out.update({f"D.{k}": p for k, p in trainer.d.named_parameters()})
    return out


def _dparam(leaves: dict, state: dict) -> dict:
    start = {f"G.{k}": v for k, v in state["G"].items()}
    for n, sd in state["D"].items():
        start.update({f"D.{n}.{k}": v for k, v in sd.items()})
    return check.norms({k: p.detach().float() - start[k].float()
                        for k, p in leaves.items()})


def drive_checked(step, leaves, optimizers, visuals, state, batches,
                  beta1) -> dict:
    """The checked steps of one trainer: `step(batch) -> losses`; the
    readings of train_checks."""
    out = {"losses": []}
    for i, batch in enumerate(batches):
        out["losses"].append(step(batch))
        if i == 0:
            out["grad1"] = check.adam_grad1(leaves(), optimizers(), beta1)
            out["fake1"] = {k: v for k, v in visuals().items()
                            if k.startswith("fake_")}
    out["dparam3"] = _dparam(leaves(), state)
    return out


def snapshot(trainer) -> dict:
    """A copy of the trainer's state between two steps: G's and the Ds'
    state dicts, and each leaf's Adam moments and step count."""
    def copy(sd):
        return {k: v.detach().clone() for k, v in sd.items()}
    opt_state = {}
    for opt in (trainer.g_opt, trainer.d_opt):
        opt_state.update(opt.state)
    return {"G": copy(trainer.g.state_dict()),
            "D": {n: copy(d.state_dict()) for n, d in trainer.d.items()},
            "adam": {k: copy(opt_state[p])
                     for k, p in program_leaves(trainer).items()
                     if p in opt_state}}


def one_step(step, leaves, visuals, snap, batch) -> dict:
    """The readings of one step from the state `snap` holds."""
    losses = step(batch)
    return {"losses": losses,
            "fake": {k: v for k, v in visuals().items()
                     if k.startswith("fake_")},
            "dparam": _dparam(leaves(), snap)}


def program_step(trainer, batch) -> dict:
    trainer.set_input(batch)
    trainer.optimize_parameters()
    return trainer.get_current_losses()


def program_after(trainer, batch) -> tuple:
    """(the trainer's state, the readings of one more step from it)."""
    snap = snapshot(trainer)
    return snap, one_step(lambda b: program_step(trainer, b),
                          lambda: program_leaves(trainer),
                          trainer.get_current_visuals, snap, batch)


def _ref_trainer(config, mix, state, device):
    return RefTrainer.from_state(
        ref_spec(config), state, device, loss_set=config["loss_set"],
        lr=mix["lr"], beta1=mix["beta1"], lambda_vgg=mix["lambda_vgg"],
        skip_threshold=mix["skip_threshold"])


def reference_readings(config, mix, seed, pool, device, after=None,
                       control=None, half_batch=False, noise=None) -> dict:
    """The plain reference's readings on the run's weights and checked
    batches and, given `after` = (the program's state after the window,
    the batch of its step from it), of that step from that state.
    `control` ("tf32", "fp8") computes it one precision below,
    `half_batch` drops the second half of each batch (a fault), `noise`
    (a draw's number) moves the hazy input of each step by uniform noise
    of at most 1e-6 (a witness of near-ties)."""
    spec = ref_spec(config)
    state = draw_all(spec, list(branch_names(spec).values()), seed, device)
    ref = _ref_trainer(config, mix, state, device)
    calls = [0]

    def tensors(batch):
        t = {k: torch.from_numpy(v).to(device).permute(0, 3, 1, 2).contiguous()
             for k, v in batch.items()}
        if half_batch:
            t = {k: v[:v.shape[0] // 2] for k, v in t.items()}
        if noise is not None:
            gen = torch.Generator(device=device).manual_seed(
                stream_seed(seed, f"noise {noise} {calls[0]}"))
            t["B"] = t["B"] + 1e-6 * (2 * torch.rand(
                t["B"].shape, generator=gen, device=device) - 1)
        calls[0] += 1
        return t

    with plain(control):
        out = drive_checked(lambda b: ref.step(tensors(b)), ref.leaves,
                            ref.optimizers, ref.visuals, state,
                            pool[:mix["checked_steps"]], mix["beta1"])
        del ref, state
        if after is not None:
            out["after"] = _reference_after(config, mix, seed, *after, device,
                                            tensors)
    return out


def _reference_after(config, mix, seed, snap, batch, device, tensors) -> dict:
    """One reference step from the program's state `snap`, with the
    reference's own VGG19 (drawn from the seed) and, for the leaves it
    reaches, the gradient of that step as Adam got it."""
    with torch.device("meta"):
        meta_vgg = VGG19()
    vgg = draw(meta_vgg, seed, "VGG19", device)
    ref = _ref_trainer(config, mix, {"G": snap["G"], "D": snap["D"],
                                     "VGG": vgg}, device)
    ref.ready = True                    # the ActNorms are in the state
    for k, p in ref.leaves().items():
        opt = ref.g_opt if k.startswith("G.") else ref.d_opt
        opt.state[p] = {n: v.clone() for n, v in snap["adam"][k].items()}
    out = one_step(lambda b: ref.step(tensors(b)), ref.leaves, ref.visuals,
                   snap, batch)
    b1 = mix["beta1"]
    new = {}
    for opt in ref.optimizers():
        new.update(opt.state)
    out["grad"] = check.norms({
        k: (new[p]["exp_avg"] - b1 * snap["adam"][k]["exp_avg"]) / (1 - b1)
        for k, p in ref.leaves().items()})
    return out


def setup_program(config, mix, seed, device, t0=None):
    """(trainer, pool, drawn state) with the weights loaded."""
    from cfen_vit_tpu_torch.config import set_precision
    from cfen_vit_tpu_torch.models.dehazing_model import create_model
    cfg = program_config(
        config, mix, device, True, ndf=config["ndf"], remat=True,
        remat_mode=mix["remat_mode"], lr=mix["lr"], beta1=mix["beta1"],
        lambda_vgg=mix["lambda_vgg"], skip_threshold=mix["skip_threshold"])
    set_precision(cfg.precision)
    trainer = create_model(cfg, device)
    if t0 is not None:
        stage(t0, "trainer built")
    spec = ref_spec(config)
    state = draw_all(spec, list(trainer.d.keys()), seed, device)
    trainer.load_state_dicts(g=state["G"], d=state["D"], vgg=state["VGG"])
    if t0 is not None:
        stage(t0, "weights drawn and loaded")
    if abs(trainer.lr - mix["lr"]) > 1e-12 * mix["lr"]:
        raise ValueError(f"the trainer's lr {trainer.lr} is not the mix's "
                         f"{mix['lr']}")
    return trainer, make_pool(config, mix, seed, device), state


def program_readings(trainer, pool, state, mix) -> dict:
    """The checked steps through the window's own call, and their
    readings."""
    return drive_checked(lambda b: program_step(trainer, b),
                         lambda: program_leaves(trainer),
                         lambda: (trainer.g_opt, trainer.d_opt),
                         trainer.get_current_visuals, state,
                         pool[:mix["checked_steps"]], mix["beta1"])


def work(config, mix) -> dict:
    """Counted work of one step, for the per-layer readers."""
    dtype = mix["compute_dtype"]
    unit = count_flops.train_unit(ref_spec(config), mix["batch"],
                                  config["image_side"], config["loss_set"])
    mrf = (mrf_calls(mix["batch"], config["image_side"], ITEM_BYTES[dtype])
           if config["loss_set"] == "dec" else [])
    return {"dtype": dtype, "model_flops": unit["flops"], "mrf": mrf}


def run(config, mix, seed, seconds, trace, device, t0) -> dict:
    stage(t0, "imports")
    trainer, pool, state = setup_program(config, mix, seed, device, t0)
    stage(t0, "pool made")
    checked = mix["checked_steps"]
    got = program_readings(trainer, pool, state, mix)
    accepted0 = trainer.step
    del state
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0
    stage(t0, "checked steps")

    i, failed, summary = checked, 0, None

    def one():
        nonlocal i, failed
        trainer.set_input(pool[i % len(pool)])
        before = trainer.step
        try:
            trainer.optimize_parameters()
        except RuntimeError:
            failed += 1
        else:
            failed += trainer.step == before
        i += 1

    if trace:
        with Window(mix["trace_steps"]) as w:
            for _ in range(mix["trace_steps"]):
                one()
        summary = w.summary
        window_s = summary["window_s"]
    else:
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            one()
        sync(device)
        window_s = time.perf_counter() - start
    steps = i - checked
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else 0)
    if trainer.step - accepted0 != steps - failed or accepted0 != checked:
        failed = max(failed, 1)
    after_batch = pool[i % len(pool)]
    snap, got["after"] = program_after(trainer, after_batch)
    del trainer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    stage(t0, "window closed")
    want = reference_readings(config, mix, seed, pool, device,
                              after=(snap, after_batch))
    stage(t0, "reference")
    return {"setup_s": setup_s, "attempted": steps, "failed": failed,
            "values": {"train_step_ms": 1e3 * window_s / max(steps, 1),
                       "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s},
            "memory_peak_bytes": peak, "summary": summary,
            "work": work(config, mix) if trace else None,
            "checks": check.train_checks(got, want)}
