"""Overfit smoke of the GAN trainer (counterpart of scripts/train_overfit.py):
shows that a `--model`'s trainer optimises, not only steps.

A small fixed set of synthetic hazy/clear pairs with a physical haze model
(B = A t + atm (1 - t), a smooth transmission per image; R = A and S =
luma(A) stand in for the dataset's intrinsic targets) goes through the
trainer step after step; the G loss and PSNR(fake_A, clear) are logged as
JSON lines, then a summary line.

    python -m cfen_vit_tpu_torch.train.overfit --model decr_vit \
        --steps 200 --batch 4 --size 256 --dtype bfloat16 --remat

The generator runs at full width (n_feats 24, hidden_dim_ratio 4, 4
heads); a half-res-trunk spec takes loadSize size / 2, the others size,
and the LViT tile is loadSize / 8.  `--gpu_ids -1` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import tempfile

import numpy as np


def make_overfit_set(pairs: int, size: int, seed: int = 0):
    """Fixed synthetic hazy/clear pairs, NHWC in [-1, 1] on the uint8 grid
    (so they ride the trainer's uint8 wire): low-frequency colour fields
    with hard-edged rectangles, hazed by a smooth transmission map."""
    r = np.random.RandomState(seed)
    cell = max(4, size // 16)

    def lowfreq(c, lo=0.0, hi=1.0):
        g = r.rand(pairs, size // cell, size // cell, c).astype(np.float32)
        g = np.kron(g, np.ones((1, cell, cell, 1), np.float32))
        return lo + (hi - lo) * g

    clear = lowfreq(3, 0.1, 0.9)
    for i in range(pairs):
        for _ in range(6):
            y, x = r.randint(0, size - size // 4, 2)
            h, w = r.randint(size // 8, size // 4, 2)
            clear[i, y:y + h, x:x + w] = r.rand(3).astype(np.float32)
    t = 0.25 + 0.55 * lowfreq(1)
    atm = (0.75 + 0.25 * r.rand(pairs, 1, 1, 1)).astype(np.float32)
    hazy = clear * t + atm * (1.0 - t)

    def u8norm(v):
        q = np.rint(np.clip(v, 0, 1) * 255.0).astype(np.uint8)
        return q.astype(np.float32) / 127.5 - 1.0

    luma = (0.299 * clear[..., :1] + 0.587 * clear[..., 1:2]
            + 0.114 * clear[..., 2:])
    return {"A": u8norm(clear), "B": u8norm(hazy), "R": u8norm(clear),
            "S": u8norm(luma)}


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    """PSNR of [-1, 1] images (peak 2)."""
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return 10.0 * np.log10(4.0 / max(mse, 1e-12))


def build_trainer(model: str, batch: int, size: int, dtype: str, remat: bool,
                  gpu_ids: str = "0"):
    """The trainer the train CLI would build for these flags, at full
    width; checkpoints go to a temporary directory nothing writes to."""
    from ..config import parse_args, select_device, set_precision
    from ..models.dehazing_model import _MODEL_DEFAULT_G, create_model
    from ..models.registry import generator_spec

    name = _MODEL_DEFAULT_G.get(model) or "iid_hlgvit_crs_gd4_cfs_v3"
    load = size // 2 if generator_spec(name).half_res_trunk else size
    argv = ["--name", "overfit", "--checkpoints_dir", tempfile.mkdtemp(),
            "--model", model, "--model_G", name,
            "--dataset_mode", "vit" if model == "vit" else "dec_vit",
            "--n_feats", "24", "--hidden_dim_ratio", "4", "--num_heads", "4",
            "--loadSize", str(load), "--patch_size", str(load // 8),
            "--batchSize", str(batch), "--pool_size", str(max(8, batch)),
            "--sb", "--compute_dtype", dtype, "--gpu_ids", gpu_ids,
            "--remat_mode", "branch"] + ([] if remat else ["--no_remat"])
    cfg = parse_args(argv, save_opt=False)
    set_precision(cfg.precision)
    return create_model(cfg, select_device(cfg.gpu_ids))


def run(model: str, steps: int, batch: int, size: int, pairs: int,
        dtype: str, remat: bool, log_every: int, gpu_ids: str = "0",
        quiet: bool = False):
    """Trains `steps` steps on the fixed set; returns the logged points
    ({step, psnr, losses...}); stops at the first non-finite loss."""
    tr = build_trainer(model, batch, size, dtype, remat, gpu_ids)
    data = make_overfit_set(pairs, size)
    hist = []
    for step in range(steps):
        sel = np.arange(step * batch, (step + 1) * batch) % pairs
        b = {k: v[sel] for k, v in data.items()}
        b["B_paths"] = [f"{i}.png" for i in sel]
        tr.set_input(b)
        tr.optimize_parameters()
        losses = tr.get_current_losses()
        bad = [k for k, v in losses.items() if not np.isfinite(v)]
        if step % log_every == 0 or step == steps - 1 or bad:
            vis = tr.get_current_visuals()
            hist.append({"step": step, "psnr": round(psnr(vis["fake_A"],
                                                          vis["real_A"]), 3),
                         **{k: round(v, 4) for k, v in losses.items()}})
            if not quiet:
                print(json.dumps(hist[-1]), flush=True)
        if bad:
            print(json.dumps({"step": step, "non_finite": bad}), flush=True)
            break
    return hist


def summary(model: str, hist, steps: int) -> dict:
    first, last = hist[0], hist[-1]
    return {"summary": "train_overfit", "model": model,
            "steps": last["step"] + 1, "G_first": first["G"],
            "G_last": last["G"], "psnr_first": first["psnr"],
            "psnr_last": last["psnr"],
            "psnr_best": max(h["psnr"] for h in hist),
            # -inf "decreases" but is a blow-up, not optimisation
            "g_decreased": bool(np.isfinite(last["G"])
                                and last["G"] < first["G"]),
            "psnr_improved": bool(np.isfinite(last["psnr"])
                                  and last["psnr"] > first["psnr"]),
            "finished": bool(last["step"] + 1 >= steps)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="dec_vit")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--log_every", type=int, default=25)
    ap.add_argument("--gpu_ids", default="0")
    args = ap.parse_args(argv)
    hist = run(args.model, args.steps, args.batch, args.size, args.pairs,
               args.dtype, args.remat, args.log_every, args.gpu_ids)
    out = summary(args.model, hist, args.steps)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
