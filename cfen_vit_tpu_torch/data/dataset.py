"""Datasets mirroring the reference's data layer, producing NHWC numpy
(counterpart of cfen_vit_tpu/data/dataset.py, its PIL path; the JAX
package's C++ decoder, runtime/cfen_loader.cpp, needs libjpeg's and
libpng's headers, which the card's machine lacks, and is not ported).

  * DecVitDataset <- data/dec_vit_data.py: dirs `hazy` (B) always; train
    also `clear` (A), `r` (R), `s` (S); paired by index when serial (--sb),
    one shared random index otherwise (ref :49-64); S is reduced to 1-channel
    luma 0.299/0.587/0.114 (ref :107-108).
  * VitDataset <- data/vit_data.py: `clear`+`hazy`, unpaired random B.

Transforms follow data/base_dataset.py:20-46: the default
`--resize_or_crop resize` matches no branch => no geometric transform (a
reference quirk we preserve for parity; 'resize_and_crop', 'crop',
'scale_width', 'none' are implemented); always ToTensor + Normalize(0.5)
=> float32 in [-1, 1].

The reference's folder scan (data/image_folder.py:36-46) does
`list(set(...))` and relies on callers to re-sort; we scan sorted directly.
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp",
                  ".JPG", ".JPEG", ".PNG", ".PPM", ".BMP")


def make_dataset(root: str) -> List[str]:
    assert os.path.isdir(root), f"{root} is not a valid directory"
    out = []
    for dirpath, _, fnames in sorted(os.walk(root)):
        for f in fnames:
            if f.endswith(IMG_EXTENSIONS):
                out.append(os.path.join(dirpath, f))
    return sorted(out)


def _load_image(path: str, cfg, grayscale_luma: bool = False,
                rng: Optional[random.Random] = None) -> np.ndarray:
    img = Image.open(path).convert("RGB")
    mode = cfg.resize_or_crop
    if mode == "resize_and_crop":
        img = img.resize((int(cfg.loadSize / 2), int(cfg.loadSize)),
                         Image.BICUBIC)
        img = _random_crop(img, cfg.fineSize, rng)
    elif mode == "crop":
        img = _random_crop(img, cfg.fineSize, rng)
    elif mode in ("scale_width", "scale_width_and_crop"):
        w, h = img.size
        if w != cfg.loadSize:
            img = img.resize((cfg.loadSize, int(cfg.loadSize * h / w)),
                             Image.BICUBIC)
        if mode == "scale_width_and_crop":
            img = _random_crop(img, cfg.fineSize, rng)
    # 'resize' (the default) and 'none': no geometric transform (ref quirk)
    a = np.asarray(img, dtype=np.float32) / 255.0
    a = a * 2.0 - 1.0                      # Normalize(0.5, 0.5)
    if grayscale_luma:
        a = (a[..., 0] * 0.299 + a[..., 1] * 0.587
             + a[..., 2] * 0.114)[..., None]
    return a


def _random_crop(img: Image.Image, size: int, rng: Optional[random.Random]):
    r = rng or random
    w, h = img.size
    if w == size and h == size:
        return img
    x = r.randint(0, max(0, w - size))
    y = r.randint(0, max(0, h - size))
    return img.crop((x, y, x + size, y + size))


class DecVitDataset:
    """Paired IID dehazing dataset (--dataset_mode dec_vit)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.is_train = cfg.isTrain
        root = cfg.dataroot
        self.b_paths = make_dataset(os.path.join(root, "hazy"))
        if self.is_train:
            self.a_paths = make_dataset(os.path.join(root, "clear"))
            self.r_paths = make_dataset(os.path.join(root, "r"))
            self.s_paths = make_dataset(os.path.join(root, "s"))
        self.rng = random.Random(cfg.seed)

    def __len__(self):
        return len(self.b_paths)

    def __getitem__(self, index: int) -> Dict:
        cfg = self.cfg
        if cfg.sb:
            i = index
        else:
            i = self.rng.randint(0, len(self.b_paths) - 1)
        b_path = self.b_paths[i % len(self.b_paths)]
        item = {"B": _load_image(b_path, cfg, rng=self.rng),
                "B_paths": b_path}
        if self.is_train:
            a_path = self.a_paths[i % len(self.a_paths)]
            r_path = self.r_paths[i % len(self.r_paths)]
            s_path = self.s_paths[i % len(self.s_paths)]
            item.update(
                A=_load_image(a_path, cfg, rng=self.rng),
                R=_load_image(r_path, cfg, rng=self.rng),
                S=_load_image(s_path, cfg, grayscale_luma=True, rng=self.rng),
                A_paths=a_path)
        return item


class VitDataset:
    """Unpaired clear/hazy dataset (--dataset_mode vit, the default)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.is_train = cfg.isTrain
        root = cfg.dataroot
        self.b_paths = make_dataset(os.path.join(root, "hazy"))
        self.a_paths = (make_dataset(os.path.join(root, "clear"))
                        if self.is_train else [])
        self.rng = random.Random(cfg.seed)

    def __len__(self):
        return max(len(self.b_paths), len(self.a_paths))

    def __getitem__(self, index: int) -> Dict:
        cfg = self.cfg
        if cfg.sb:
            bi = index % len(self.b_paths)
        else:
            bi = self.rng.randint(0, len(self.b_paths) - 1)
        item = {"B": _load_image(self.b_paths[bi], cfg, rng=self.rng),
                "B_paths": self.b_paths[bi]}
        if self.is_train:
            ai = index % len(self.a_paths)
            item.update(A=_load_image(self.a_paths[ai], cfg, rng=self.rng),
                        A_paths=self.a_paths[ai])
        return item
