"""Closed-loop EPDN training: the port's EpdnTrainer (train/pix2pixhd.py),
as `create_model` builds it for `python -m cfen_vit_tpu_torch.train
--model epdn`, steps through a pool of distinct (hazy, clear) batches.

Set-up builds the trainer from the configuration's widths and fails if
the networks it built are not the configuration's (every tensor's shape
against the plain reference's, reference/epdn.py, built from the same
keys), loads weights drawn from the seed on the device
(reference/weights.py), makes the pool (loops/hazy.py, the data
loader's float32 NHWC in [-1, 1]) and drives the trainer through its
first `checked_steps` steps on pool batches 0, 1, 2 with the window's
own call.  The window then steps on through the pool for `seconds` and
ends with a torch.cuda.synchronize(): train_step_ms is its wall time
over its steps.  A step that raises is failed.

Once the window has closed, the trainer's state (G, D, every Adam
moment and step count, the image pool and its generator) is copied and
the trainer takes one more step.  The plain reference replays the
checked steps from the same weights and the pool generator's first
state, and that last step from the copied state; the numbers are those
of the training cells (check.py `train_checks`), over the leaves
G.<name> and D.<name>.  What the dehazing trainer's loop
(loops/train_closed.py) has in common with this one is taken from it;
what is here is EPDN's: one D state dict, the image pool and its
generator in the snapshot, and the reference.
"""

from __future__ import annotations

import gc
import time

import torch

from .. import check
from ..counts import epdn_flops
from ..reference import epdn as E
from ..reference.losses import VGG19
from ..reference.weights import build, draw, stream_seed
from ..trace import Window
from . import hazy
from .common import plain, stage, sync
from .train_closed import program_leaves as leaves, program_step


def program_config(config: dict, mix: dict, seed: int, device):
    """The port's Config of the cell: the configuration's widths, the mix's
    batch, arithmetic and Adam, the pool's generator seeded from the run."""
    from cfen_vit_tpu_torch.config import Config
    cfg = Config(
        model=config["model"], epdn_ngf=config["ngf"], ndf=config["ndf"],
        num_D=config["num_D"], n_layers_D=config["n_layers_D"],
        lambda_feat=config["lambda_feat"],
        no_lsgan=config["gan_mode"] != "lsgan",
        pool_size=config["pool_size"], batchSize=mix["batch"],
        compute_dtype=mix["compute_dtype"], precision=mix["precision"],
        lr=mix["lr"], beta1=mix["beta1"],
        seed=stream_seed(seed, "pool") % 2 ** 62,
        gpu_ids="-1" if device.type == "cpu" else str(device.index or 0))
    cfg.isTrain = True
    cfg.validate()
    return cfg


def meta_nets(config: dict) -> tuple:
    """(G, D, VGG19) of the reference on the meta device."""
    with torch.device("meta"):
        return (E.LocalEnhancer(config), E.MultiscaleDiscriminator(config),
                VGG19())


def draw_state(config: dict, seed: int, device) -> dict:
    g, d, vgg = meta_nets(config)
    return {"G": draw(g, seed, "EPDN_G", device),
            "D": draw(d, seed, "EPDN_D", device),
            "VGG": draw(vgg, seed, "VGG19", device)}


def check_widths(trainer, config: dict) -> None:
    """Raises unless the trainer's G and D hold the tensors the
    configuration's keys give."""
    g, d, _ = meta_nets(config)
    for name, want, got in (("G", g, trainer.g), ("D", d, trainer.d)):
        if E.shapes(got) != E.shapes(want):
            diff = sorted(set(E.shapes(got).items())
                          ^ set(E.shapes(want).items()))
            raise ValueError(f"the EPDN {name} built is not the "
                             f"configuration's: {diff[:4]}")


def make_pool(config: dict, mix: dict, seed: int, device) -> list:
    """`pool_batches` batches of {B, A} as host float32 NHWC."""
    b, side = mix["batch"], config["image_side"]
    sc = hazy.scenes(mix["pool_batches"] * b, side, seed, device)
    arrays = {"B": hazy.loader_floats(sc["hazy"]).cpu().numpy(),
              "A": hazy.loader_floats(sc["clear"]).cpu().numpy()}
    return [{k: v[i * b:(i + 1) * b] for k, v in arrays.items()}
            for i in range(mix["pool_batches"])]


def _dparam(now: dict, state: dict) -> dict:
    """Each leaf's change from `state`'s G and D."""
    start = {f"{n}.{k}": v for n in ("G", "D") for k, v in state[n].items()}
    return check.norms({k: p.detach().float() - start[k].float()
                        for k, p in now.items()})


def _fakes(visuals: dict) -> dict:
    return {k: v for k, v in visuals.items() if k.startswith("fake_")}


def drive_checked(step, leaves_of, optimizers, visuals, state, batches,
                  beta1) -> dict:
    """The checked steps of one trainer: `step(batch) -> losses`; the
    readings of check.train_checks."""
    out = {"losses": []}
    for i, batch in enumerate(batches):
        out["losses"].append(step(batch))
        if i == 0:
            out["grad1"] = check.adam_grad1(leaves_of(), optimizers(), beta1)
            out["fake1"] = _fakes(visuals())
    out["dparam3"] = _dparam(leaves_of(), state)
    return out


def snapshot(trainer) -> dict:
    """A copy of the trainer's state between two steps."""
    def copy(sd):
        return {k: v.detach().clone() for k, v in sd.items()}
    opt_state = {}
    for opt in (trainer.g_opt, trainer.d_opt):
        opt_state.update(opt.state)
    pool = trainer.pool
    return {"G": copy(trainer.g.state_dict()),
            "D": copy(trainer.d.state_dict()),
            "adam": {k: copy(opt_state[p]) for k, p in leaves(trainer).items()
                     if p in opt_state},
            "pool": [pool["buf"][i].clone() for i in range(pool["n"])],
            "pool_gen": trainer.pool_gen.get_state()}


def program_after(trainer, batch) -> tuple:
    """(the trainer's state, the readings of one more step from it)."""
    snap = snapshot(trainer)
    losses = program_step(trainer, batch)
    return snap, {"losses": losses,
                  "fake": _fakes(trainer.get_current_visuals()),
                  "dparam": _dparam(leaves(trainer), snap)}


def setup_program(config, mix, seed, device, t0=None):
    """(trainer, pool, drawn state, the pool generator's first state)."""
    from cfen_vit_tpu_torch.config import set_precision
    from cfen_vit_tpu_torch.models.dehazing_model import create_model
    cfg = program_config(config, mix, seed, device)
    set_precision(cfg.precision)
    trainer = create_model(cfg, device)
    check_widths(trainer, config)
    if t0 is not None:
        stage(t0, "trainer built")
    state = draw_state(config, seed, device)
    trainer.load_state_dicts(g=state["G"], d=state["D"], vgg=state["VGG"])
    if t0 is not None:
        stage(t0, "weights drawn and loaded")
    if abs(trainer.lr - mix["lr"]) > 1e-12 * mix["lr"]:
        raise ValueError(f"the trainer's lr {trainer.lr} is not the mix's "
                         f"{mix['lr']}")
    return (trainer, make_pool(config, mix, seed, device), state,
            trainer.pool_gen.get_state())


def program_readings(trainer, pool, state, mix) -> dict:
    return drive_checked(lambda b: program_step(trainer, b),
                         lambda: leaves(trainer),
                         lambda: (trainer.g_opt, trainer.d_opt),
                         trainer.get_current_visuals, state,
                         pool[:mix["checked_steps"]], mix["beta1"])


def _reference(config, mix, state, pool_images, pool_gen, device):
    gen = torch.Generator()
    gen.set_state(pool_gen)
    pool = E.Pool(config["pool_size"], gen)
    pool.images = [v.clone() for v in pool_images]
    return E.RefEpdn(
        config, build(lambda: E.LocalEnhancer(config), state["G"], device),
        build(lambda: E.MultiscaleDiscriminator(config), state["D"], device),
        build(VGG19, state["VGG"], device), pool, mix["lr"], mix["beta1"])


def reference_readings(config, mix, seed, pool, pool_gen, device, after=None,
                       control=None, half_batch=False) -> dict:
    """The plain reference's readings on the run's weights, checked
    batches and the pool generator's first state and, given `after` =
    (the program's state after the window, the batch of its step from
    it), of that step from that state.  `control` ("tf32", "fp8")
    computes it one precision below, `half_batch` drops the second half
    of each batch (a fault)."""
    state = draw_state(config, seed, device)

    def tensors(batch):
        t = {k: torch.from_numpy(v).to(device).permute(0, 3, 1, 2).contiguous()
             for k, v in batch.items()}
        if half_batch:
            t = {k: v[:v.shape[0] // 2] for k, v in t.items()}
        return t

    with plain(control):
        ref = _reference(config, mix, state, [], pool_gen, device)
        out = drive_checked(lambda b: ref.step(tensors(b)), ref.leaves,
                            ref.optimizers, ref.visuals, state,
                            pool[:mix["checked_steps"]], mix["beta1"])
        del ref
        if after is not None:
            snap, batch = after
            ref = _reference(config, mix, {**snap, "VGG": state["VGG"]},
                             snap["pool"], snap["pool_gen"], device)
            del state
            for k, p in ref.leaves().items():
                opt = ref.g_opt if k.startswith("G.") else ref.d_opt
                opt.state[p] = {n: v.clone()
                                for n, v in snap["adam"][k].items()}
            losses = ref.step(tensors(batch))
            b1, new = mix["beta1"], {}
            for opt in ref.optimizers():
                new.update(opt.state)
            out["after"] = {
                "losses": losses, "fake": _fakes(ref.visuals()),
                "dparam": _dparam(ref.leaves(), snap),
                "grad": check.norms({
                    k: (new[p]["exp_avg"] - b1 * snap["adam"][k]["exp_avg"])
                    / (1 - b1) for k, p in ref.leaves().items()})}
    return out


def work(config, mix) -> dict:
    """Counted work of one step, for the per-layer readers."""
    unit = epdn_flops.train_unit(config, mix["batch"], config["image_side"])
    return {"dtype": mix["compute_dtype"], "model_flops": unit["flops"]}


def run(config, mix, seed, seconds, trace, device, t0) -> dict:
    stage(t0, "imports")
    trainer, pool, state, pool_gen = setup_program(config, mix, seed, device,
                                                   t0)
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
        try:
            trainer.optimize_parameters()
        except RuntimeError:
            failed += 1
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
    want = reference_readings(config, mix, seed, pool, pool_gen, device,
                              after=(snap, after_batch))
    stage(t0, "reference")
    return {"setup_s": setup_s, "attempted": steps, "failed": failed,
            "values": {"train_step_ms": 1e3 * window_s / max(steps, 1),
                       "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s},
            "memory_peak_bytes": peak, "summary": summary,
            "work": work(config, mix) if trace else None,
            "checks": check.train_checks(got, want)}


def readings(cell, seed, device, controls, window) -> list:
    """[(kind, numbers)] for calibrate_loops.py: the program against the
    reference after `window` steps between the checked ones and the step
    after them and, with `controls`, the control and the half batch in
    the program's place."""
    from ..calibrate import _free
    cfg, mix = cell.config, cell.mix
    trainer, pool, state, pool_gen = setup_program(cfg, mix, seed, device)
    got = program_readings(trainer, pool, state, mix)
    n = mix["checked_steps"]
    for j in range(n, n + window):
        program_step(trainer, pool[j % len(pool)])
    batch = pool[(n + window) % len(pool)]
    snap, got["after"] = program_after(trainer, batch)
    del trainer, state
    _free(device)
    kw = dict(after=(snap, batch))
    want = reference_readings(cfg, mix, seed, pool, pool_gen, device, **kw)
    rows = [("program", check.train_checks(got, want, look=True))]
    others = ([("control", dict(control=mix["control"])),
               ("half_batch", dict(half_batch=True))] if controls else [])
    for kind, opts in others:
        _free(device)
        r = reference_readings(cfg, mix, seed, pool, pool_gen, device, **kw,
                               **opts)
        rows.append((kind, check.train_checks(r, want, look=True)))
    _free(device)
    return rows
