"""Image IO helpers mirroring util/util.py and util/visualizer.py
(counterpart of cfen_vit_tpu/utils/images.py; PNGs go through PIL).

tensor2im follows util/util.py:12-24: [-1,1] float -> uint8, 1-channel
tiled to 3.  save_images follows util/visualizer.py:10-27: one
`<name>_<label>.png` per visual per batch item into the gallery image dir.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
from PIL import Image


def tensor2im(img: np.ndarray, imtype=np.uint8) -> np.ndarray:
    """[H,W,C] or [H,W,1] float in [-1,1] -> [H,W,3] uint8.

    uint8 input passes through (already converted on-device by the
    uint8-wire inference path)."""
    a = np.asarray(img)
    if a.ndim == 3 and a.shape[-1] == 1:
        a = np.tile(a, (1, 1, 3))
    if a.dtype == np.uint8:
        return a
    a = (np.asarray(a, np.float32) + 1.0) / 2.0 * 255.0
    return a.astype(imtype)


def save_image(image_numpy: np.ndarray, image_path: str) -> None:
    Image.fromarray(image_numpy).save(image_path)


def mkdirs(paths) -> None:
    if isinstance(paths, (list, tuple)):
        for p in paths:
            os.makedirs(p, exist_ok=True)
    else:
        os.makedirs(paths, exist_ok=True)


def save_images(image_dir: str, visuals: Dict[str, np.ndarray],
                image_paths: List[str], aspect_ratio: float = 1.0,
                width: int = 256, webpage=None) -> None:
    """visuals: label -> [B,H,W,C] batch in [-1,1]."""
    os.makedirs(image_dir, exist_ok=True)
    jobs = []
    for b, path in enumerate(image_paths):
        short = os.path.splitext(os.path.basename(path))[0]
        ims, txts, links = [], [], []
        for label, batch in visuals.items():
            im = tensor2im(batch[b])
            name = f"{short}_{label}.png"
            jobs.append((im, os.path.join(image_dir, name)))
            ims.append(name)
            txts.append(label)
            links.append(name)
        if webpage is not None:
            webpage.add_header(short)
            webpage.add_images(ims, txts, links, width=width)
    # PNG encode is zlib-bound and releases the GIL
    with ThreadPoolExecutor(min(8, max(1, len(jobs)))) as pool:
        list(pool.map(lambda j: save_image(*j), jobs))
