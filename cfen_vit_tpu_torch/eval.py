"""Evaluation CLI: PSNR, SSIM and MS-SSIM between two image folders
(counterpart of the repository's eval.py).

    python -m cfen_vit_tpu_torch.eval --pred results/<name>/test_32/images \
        --gt <root>/clear [--suffix _fake_A] [--msssim] [--json] [--gpu_ids 0]

Pairs files by basename after stripping --suffix from the predictions'
stems, as eval.py does (with `--suffix ''` that strips the whole stem, so
nothing pairs: eval.py's behaviour, kept).  Images go to [-1, 1] and
through ops/ssim.py on `--gpu_ids`' device (0 = cuda:0, the default,
which raises without CUDA; -1 = the CPU), in float32 without TF32.
Prints eval.py's line, or its JSON with --json; exits 2 when nothing
pairs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _collect(d):
    exts = (".png", ".jpg", ".jpeg", ".bmp", ".PNG", ".JPG")
    return sorted(f for f in os.listdir(d) if f.endswith(exts))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pred", required=True)
    ap.add_argument("--gt", required=True)
    ap.add_argument("--suffix", default="_fake_A",
                    help="suffix stripped from prediction basenames")
    ap.add_argument("--msssim", action="store_true")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--gpu_ids", default="0",
                    help="-1 is the CPU, N is cuda:N")
    args = ap.parse_args(argv)

    import torch
    from PIL import Image
    from cfen_vit_tpu_torch.config import select_device, set_precision
    from cfen_vit_tpu_torch.ops.ssim import msssim, psnr, ssim

    device = select_device(args.gpu_ids)
    set_precision("highest")
    gts = {os.path.splitext(f)[0]: os.path.join(args.gt, f)
           for f in _collect(args.gt)}
    pairs = []
    for f in _collect(args.pred):
        stem = os.path.splitext(f)[0]
        if stem.endswith(args.suffix):
            stem = stem[: -len(args.suffix)]
        if stem in gts:
            pairs.append((os.path.join(args.pred, f), gts[stem]))
    if not pairs:
        print("no matched prediction/gt pairs", file=sys.stderr)
        return 2

    def load(path):
        a = np.asarray(Image.open(path).convert("RGB"), np.float32)[None]
        return torch.from_numpy(a / 255.0 * 2 - 1).permute(0, 3, 1, 2).to(device)

    psnrs, ssims, msssims = [], [], []
    with torch.inference_mode():
        for p, g in pairs:
            a, b = load(p), load(g)
            if a.shape != b.shape:
                print(f"skip {os.path.basename(p)}: shape {tuple(a.shape)} vs "
                      f"{tuple(b.shape)}", file=sys.stderr)
                continue
            psnrs.append(float(psnr(a, b)))
            ssims.append(float(ssim(a, b)))
            if args.msssim:
                msssims.append(float(msssim(a, b)))

    out = {"n": len(psnrs),
           "psnr": round(float(np.mean(psnrs)), 4),
           "ssim": round(float(np.mean(ssims)), 5)}
    if msssims:
        out["msssim"] = round(float(np.mean(msssims)), 5)
    if args.json:
        print(json.dumps(out))
    else:
        print(f"n={out['n']} PSNR={out['psnr']:.2f}dB SSIM={out['ssim']:.4f}"
              + (f" MS-SSIM={out['msssim']:.4f}" if msssims else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
