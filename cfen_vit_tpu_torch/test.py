"""Inference CLI (counterpart of the repository's test.py).

    python -m cfen_vit_tpu_torch.test --dataroot R --name NAME \
        --model dec_vit --dataset_mode dec_vit \
        --model_G iid_hlgvit_crs_gd4_cfs_v3 --n_feats 24 --hidden_dim_ratio 4 \
        --sb --out_all --which_epoch 32 --gpu_ids 0

Same flags and outputs as test.py: `<dataroot>/hazy/*` in,
`<results_dir>/<name>/<phase>_<which_epoch>/images/<img>_<label>.png` and
an index.html out.  `--gpu_ids 0` runs on cuda:0 (and raises without
CUDA), `--gpu_ids -1` on the CPU.
"""

from __future__ import annotations

import logging
import os
import time


def main(argv=None) -> dict:
    """Runs the CLI; returns the image count and timings it prints."""
    from cfen_vit_tpu_torch.config import (parse_args, select_device,
                                           set_precision)
    from cfen_vit_tpu_torch.data import create_dataloader
    from cfen_vit_tpu_torch.models.dehazing_model import DehazingModel
    from cfen_vit_tpu_torch.utils import HTML, save_images

    cfg = parse_args(argv, is_train=False)
    device = select_device(cfg.gpu_ids)
    set_precision(cfg.precision)
    dataset = create_dataloader(cfg).load_data()
    model = DehazingModel(cfg, device)
    model.setup(cfg)

    web_dir = os.path.join(cfg.results_dir, cfg.name,
                           f"{cfg.phase}_{cfg.which_epoch}")
    webpage = HTML(web_dir, f"Experiment = {cfg.name}, Phase = {cfg.phase}, "
                            f"Epoch = {cfg.which_epoch}")

    n_images, t0 = 0, time.perf_counter()
    n_steady, t_first_done = 0, None
    for i, data in enumerate(dataset):
        if i >= cfg.how_many:
            break
        model.set_input(data)
        visuals = model.test()
        if cfg.out_all:
            visuals = {k: v for k, v in visuals.items() if "fake_A" in k}
        img_path = model.get_image_paths()
        if i % 5 == 0:
            logging.info("processing (%04d)-th image...", i * cfg.batchSize)
        save_images(webpage.get_image_dir(), visuals, img_path,
                    aspect_ratio=cfg.aspect_ratio,
                    width=cfg.display_winsize, webpage=webpage)
        n_images += len(img_path)
        if t_first_done is None:
            # batch 0 carries the kernel build and cuDNN's first-call setup;
            # the steady rate excludes it
            t_first_done = time.perf_counter()
        else:
            n_steady += len(img_path)
    webpage.save()
    t_end = time.perf_counter()
    stats = {"images": n_images, "seconds": t_end - t0, "device": str(device),
             "steady_img_per_s": (n_steady / (t_end - t_first_done)
                                  if n_steady else None)}
    steady = (f" (steady {stats['steady_img_per_s']:.2f} img/s after batch 0)"
              if n_steady else "")
    print(f"processed {n_images} images in {stats['seconds']:.2f}s on "
          f"{device}{steady} -> {web_dir}")
    return stats


if __name__ == "__main__":
    main()
