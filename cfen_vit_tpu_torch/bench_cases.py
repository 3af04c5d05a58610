"""What chip_smoke.py and `python -m cfen_vit_tpu_torch.bench_conv` share:
device and event times of a call on the card, and the ViT blocks K2
(csrc/vit.cu) is timed at, with their seeded weights and tokens.  The
timing helpers and k2_case run on the card."""

from __future__ import annotations

import statistics

import torch

BATCH = 4   # the batch chip_smoke.py and bench_conv time K2's blocks at


def device_times(fn, reps: int = 20, tries: int = 5) -> dict | None:
    """Device time per call of fn of each kernel it launches, by kernel
    name, from torch.profiler's CUDA activity over reps calls.  A trace
    that lost records (on the H100 a profile now and then held none of a
    call's kernels, or some of them) shows no kernel, or a kernel a number
    of times that reps does not divide: it is taken again, up to `tries`
    times; None if no trace was whole."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times, whole = {}, True
        for e in prof.key_averages():
            t = (getattr(e, "self_device_time_total", 0)
                 or getattr(e, "self_cuda_time_total", 0))
            if t:
                times[e.key] = times.get(e.key, 0.0) + t / 1e3 / reps
                whole &= e.count % reps == 0
        if times and whole:
            return times
    return None


def device_ms(fn, kernel_name: str = "", reps: int = 20) -> float | None:
    """Device time of one call of fn summed over the kernels whose name
    contains kernel_name (all of them by default); None if not measured
    (device_times)."""
    times = device_times(fn, reps)
    return None if times is None else sum(v for k, v in times.items() if kernel_name in k)


def event_ms(fn, reps: int = 20) -> float:
    """Median CUDA-event time of fn, synchronising after every launch."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def k2_blocks(spec, batch: int = BATCH):
    """(label, ViTSpec, rows) of the blocks K2 takes at the batch: LViT L3
    and GViT L1 by default, LViT L1 and L2 with CFEN_PALLAS_VIT_MIN_E=0."""
    tiles = {lvl: (spec.level_size(lvl) // spec.patch_size) ** 2
             for lvl in (1, 2, 3)}
    return [("LViT L3", spec.lvit_spec(3), batch * tiles[3]),
            ("GViT L1", spec.gvit_spec(1, encoder=False), batch),
            ("LViT L1", spec.lvit_spec(1), batch * tiles[1]),
            ("LViT L2", spec.lvit_spec(2), batch * tiles[2])]


def k2_case(vspec, n, dtype, seed):
    """A ViT block with the generator's init plus random biases and
    LayerNorm affines (so every term counts), and seeded tokens, on the
    card in dtype."""
    from .models.generator import init_weights
    from .models.vit import ViT
    g = torch.Generator().manual_seed(seed)
    vit = init_weights(ViT(vspec), g)
    with torch.no_grad():
        for name, prm in vit.named_parameters():
            if name.endswith("bias") or "norm" in name:
                prm.add_(torch.randn(prm.shape, generator=g) * 0.1)
    t = torch.randn(n, vspec.seq_length, vspec.embedding_dim, generator=g)
    return vit.to("cuda", dtype).eval(), t.to("cuda", dtype)
