"""Training visualizer: console/loss-log/HTML snapshots (counterpart of
cfen_vit_tpu/utils/visualizer.py).

Mirrors util/visualizer.py's observable behavior without visdom:
  * loss_log.txt created with a timestamped header and appended one line
    per print (ref :48-51, :139-146), same line format
    `(epoch: E, iters: I, time: T, data: D) name: value ...`;
  * per-epoch HTML snapshot of current visuals under
    checkpoints/<name>/web/images (ref :101-120);
  * display_id <= 0 => no live plotting (visdom is not reproduced).
"""

from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np

from .html import HTML
from .images import tensor2im, save_image, mkdirs


class Visualizer:
    def __init__(self, cfg):
        self.cfg = cfg
        self.name = cfg.name
        self.use_html = cfg.isTrain and not cfg.no_html
        self.win_size = cfg.display_winsize
        self.saved = False
        if self.use_html:
            self.web_dir = os.path.join(cfg.checkpoints_dir, cfg.name, "web")
            self.img_dir = os.path.join(self.web_dir, "images")
            mkdirs([self.web_dir, self.img_dir])
        self.log_name = os.path.join(cfg.checkpoints_dir, cfg.name,
                                     "loss_log.txt")
        os.makedirs(os.path.dirname(self.log_name), exist_ok=True)
        with open(self.log_name, "a") as fh:
            now = time.strftime("%c")
            fh.write(f"================ Training Loss ({now}) ================\n")

    def reset(self):
        self.saved = False

    def display_current_results(self, visuals: Dict[str, np.ndarray],
                                epoch: int, save_result: bool):
        if self.use_html and (save_result or not self.saved):
            self.saved = True
            for label, image in visuals.items():
                img = image[0] if image.ndim == 4 else image
                save_image(tensor2im(img), os.path.join(
                    self.img_dir, f"epoch{epoch:03d}_{label}.png"))
            webpage = HTML(self.web_dir,
                           f"Experiment name = {self.name}", refresh=1)
            for n in range(epoch, 0, -1):
                webpage.add_header(f"epoch [{n}]")
                ims, txts, links = [], [], []
                for label in visuals:
                    fname = f"epoch{n:03d}_{label}.png"
                    ims.append(fname)
                    txts.append(label)
                    links.append(fname)
                webpage.add_images(ims, txts, links, width=self.win_size)
            webpage.save()

    def print_current_losses(self, epoch: int, i: int,
                             losses: Dict[str, float],
                             t: float, t_data: float):
        msg = f"(epoch: {epoch}, iters: {i}, time: {t:.3f}, data: {t_data:.3f}) "
        for k, v in losses.items():
            msg += f"{k}: {float(v):.3f} "
        print(msg)
        with open(self.log_name, "a") as fh:
            fh.write(msg + "\n")
