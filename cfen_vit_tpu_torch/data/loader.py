"""Batching data loader with background prefetch (counterpart of
cfen_vit_tpu/data/loader.py, PIL decode only).

Replaces the reference's torch DataLoader wrapper (data/__init__.py:10-60):
create_dataloader(cfg) -> iterable of dicts of numpy batches, honoring
batchSize / shuffle-unless-sb / nThreads / max_dataset_size semantics.

Decode runs in a thread pool (PIL releases the GIL for decode) with a
bounded prefetch queue, so host IO overlaps device compute.

Under data parallel (parallel/mesh.py) every rank draws the same order
(a shuffle seeded by --seed and the epoch) and decodes only its
contiguous shard of each global batch.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List

import numpy as np

from .dataset import DecVitDataset, VitDataset


def create_dataset(cfg):
    if cfg.dataset_mode == "dec_vit":
        return DecVitDataset(cfg)
    if cfg.dataset_mode == "vit":
        return VitDataset(cfg)
    raise ValueError(f"Dataset mode [{cfg.dataset_mode}] not recognized.")


def _collate(items: List[Dict]) -> Dict:
    out: Dict = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        if isinstance(vals[0], np.ndarray):
            shapes = {v.shape for v in vals}
            if len(shapes) > 1:
                raise ValueError(
                    f"batch of '{k}' mixes image sizes {sorted(shapes)}; "
                    "use --batchSize 1, pre-resize the folder, or --chop "
                    "for large images (the reference crashes identically "
                    "in default_collate)")
            out[k] = np.stack(vals).astype(np.float32)
        else:
            out[k] = vals
    return out


class DataLoader:
    def __init__(self, cfg, mesh=None):
        self.cfg = cfg
        self.dataset = create_dataset(cfg)
        self.batch_size = cfg.batchSize
        self.workers = max(1, int(cfg.nThreads) or 1)
        self.mesh = mesh
        self._epochs = 0

    def __len__(self):
        return int(min(len(self.dataset), self.cfg.max_dataset_size))

    def load_data(self):
        return self

    def __iter__(self) -> Iterator[Dict]:
        n = len(self.dataset)
        order = list(range(n))
        sharded = self.mesh is not None and self.mesh.size > 1
        if not self.cfg.sb:
            if sharded:     # the same order on every rank
                np.random.RandomState(
                    int(self.cfg.seed) + self._epochs).shuffle(order)
            else:
                np.random.shuffle(order)
        self._epochs += 1
        batches = [order[i:i + self.batch_size]
                   for i in range(0, n, self.batch_size)]
        # Training drops the trailing partial batch, as the JAX package
        # does; eval keeps every image.
        if (getattr(self.cfg, "isTrain", False) and batches
                and len(batches[-1]) < self.batch_size):
            batches = batches[:-1]
        if sharded:
            batches = [b[self.mesh.shard(self.batch_size)] for b in batches]

        limit = self.cfg.max_dataset_size

        def make(batch_idx):
            return _collate([self.dataset[i] for i in batch_idx])

        if self.workers <= 1:
            for bi, batch in enumerate(batches):
                if bi * self.batch_size >= limit:
                    break
                yield make(batch)
            return

        q: queue.Queue = queue.Queue(maxsize=2 * self.workers)
        stop = threading.Event()

        def producer():
            with ThreadPoolExecutor(self.workers) as pool:
                futs = [pool.submit(make, b) for b in batches]
                for f in futs:
                    if stop.is_set():
                        return
                    q.put(f.result())
            q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        served = 0
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if served * self.batch_size >= limit:
                    break
                served += 1
                yield item
        finally:
            stop.set()


def create_dataloader(cfg, mesh=None) -> DataLoader:
    return DataLoader(cfg, mesh)
