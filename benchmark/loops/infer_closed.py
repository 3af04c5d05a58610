"""Closed-loop inference: one batch in flight through the port's model
wrapper (models/dehazing_model.py DehazingModel), as the test CLI drives
it without its PNG I/O: `set_input({"B": uint8 NHWC})`, then `test()`,
which returns host uint8 fake_A.

Set-up builds the wrapper (on the meta device, then filled: nothing is
drawn twice), draws the generator's weights from the seed on the device,
sets its ActNorms by the plain reference's data-dependent init pass on
the pool's first batch (float32, every branch: what a trained
checkpoint would hold), makes a pool of distinct hazy images
(loops/hazy.py) and warms the batch's shapes.  The window cycles through
the pool; each batch's latency is the host time from set_input to the
host arrays.  The outputs of a seed-drawn sample of batches (every pool
batch's first pass among them) are compared with the plain reference's
once the window has closed.
"""

from __future__ import annotations

import gc
import random
import time

import numpy as np
import torch

from .. import check
from ..counts import flops as count_flops
from ..counts.kernels import attention_work
from ..counts.peaks import ITEM_BYTES
from ..reference.nets import Generator
from ..reference.weights import build, draw
from ..trace import Window
from . import hazy
from .common import plain, program_config, ref_spec, stage, sync


def weights(config, mix, pool_u8, seed, device):
    """The reference generator with the run's weights: drawn from the
    seed, ActNorms set by its init pass on the pool's first batch."""
    spec = ref_spec(config)
    with torch.device("meta"):
        meta = Generator(spec)
    g = build(lambda: Generator(spec), draw(meta, seed, "G", device), device)
    x = pool_u8[:mix["batch"]].permute(0, 3, 1, 2).float() / 127.5 - 1.0
    with torch.no_grad():
        g(x, init=True)
    return g


def reference_outputs(config, mix, pool_u8, keys, seed, device,
                      control=None) -> dict:
    """{pool batch: uint8 fake_A} of the plain reference (float32, TF32
    off; `control` one precision below)."""
    g = weights(config, mix, pool_u8, seed, device)
    b, out = mix["batch"], {}
    with plain(control), torch.no_grad():
        for k in keys:
            x = pool_u8[k * b:(k + 1) * b].permute(0, 3, 1, 2).float()
            d = g(x / 127.5 - 1.0, branches="d" if mix["out_all"] else None)
            out[k] = ((d["d"] + 1.0) * 127.5).to(torch.uint8).permute(
                0, 2, 3, 1).cpu().numpy()
    return out


def setup_program(config, mix, seed, device):
    """(model, device pool, host pool)."""
    from cfen_vit_tpu_torch.config import set_precision
    from cfen_vit_tpu_torch.models.dehazing_model import DehazingModel
    cfg = program_config(config, mix, device, False, sb=True,
                         out_all=mix["out_all"], phase="test")
    set_precision(cfg.precision)
    pool = hazy.scenes(mix["pool_images"], config["image_side"], seed,
                       device)["hazy"]
    g = weights(config, mix, pool, seed, device)
    with torch.device("meta"):
        model = DehazingModel(cfg, device)
    model.net.to_empty(device=device)
    model.net.load_state_dict(g.state_dict(), strict=True)
    del g
    model.net.to(dtype=model.dtype).eval().requires_grad_(False)
    return model, pool, pool.cpu().numpy()


def sample(seed: int, n_pool: int, extra: int) -> set:
    """Window batch indices whose outputs are kept: each pool batch's
    first pass and `extra` drawn from the seed among the next 2000."""
    rng = random.Random(seed)
    return set(range(n_pool)) | set(rng.sample(range(n_pool, n_pool + 2000),
                                               extra))


def work(config, mix) -> dict:
    dtype = mix["compute_dtype"]
    unit = count_flops.infer_unit(ref_spec(config), mix["batch"],
                                  config["image_side"],
                                  "d" if mix["out_all"] else None)
    return {"dtype": dtype, "model_flops": unit["flops"],
            "attention": [attention_work(*c, ITEM_BYTES[dtype])
                          for c in unit["attention"]]}


def run(config, mix, seed, seconds, trace, device, t0) -> dict:
    stage(t0, "imports")
    model, pool_dev, pool = setup_program(config, mix, seed, device)
    stage(t0, "model built")
    b = mix["batch"]
    n_pool = len(pool) // b
    batches = [pool[k * b:(k + 1) * b] for k in range(n_pool)]
    paths = [f"hazy_{k:03d}.png" for k in range(b)]
    for k in range(mix["warm_batches"]):
        model.set_input({"B": batches[k % n_pool], "B_paths": paths})
        model.test()
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0
    stage(t0, "warm batches")

    keep = sample(seed, n_pool, mix["sample_extra"])
    kept, lat, failed, i = {}, [], 0, 0

    def one():
        nonlocal i, failed
        k = i % n_pool
        t = time.perf_counter()
        try:
            model.set_input({"B": batches[k], "B_paths": paths})
            out = model.test()["fake_A"]
        except RuntimeError:
            failed += 1
        else:
            lat.append(time.perf_counter() - t)
            if i in keep:
                kept.setdefault(k, []).append(out)
        i += 1

    summary = None
    if trace:
        with Window(mix["trace_batches"]) as w:
            for _ in range(mix["trace_batches"]):
                one()
        summary = w.summary
        window_s = summary["window_s"]
    else:
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            one()
        window_s = time.perf_counter() - start
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else 0)
    done = i - failed
    del model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    stage(t0, "window closed")
    want = reference_outputs(config, mix, pool_dev, sorted(kept), seed, device)
    stage(t0, "reference")
    if any(k not in kept for k in range(min(i, n_pool))):
        failed = max(failed, 1)
    return {"setup_s": setup_s, "attempted": i, "failed": failed,
            "values": {"infer_img_per_s": done * b / window_s,
                       "infer_p95_ms": 1e3 * float(np.percentile(lat, 95))
                       if lat else float("inf"),
                       "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s},
            "memory_peak_bytes": peak, "summary": summary,
            "work": work(config, mix) if trace else None,
            "checks": {"worst_rmse_u8": check.worst_rmse_u8(kept, want)}}
