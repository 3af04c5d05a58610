"""LR schedules (counterpart of cfen_vit_tpu/train/schedule.py; ref
models/networks.py:26-39 `get_scheduler`).

  * 'lambda': flat for `niter` epochs then linear decay to 0 over
    `niter_decay` epochs, phase-shifted by `epoch_count`
    (lr_l = 1 - max(0, epoch+1+epoch_count-niter) / (niter_decay+1));
  * 'step': x0.1 every `lr_decay_iters` epochs;
  * 'plateau' is metric-driven in the reference; provided as a host-side
    helper class since it cannot be a pure function of epoch.
"""

from __future__ import annotations


def lr_for_epoch(cfg, epoch: int) -> float:
    """epoch is the 0-based number of completed epochs (the reference steps
    its scheduler once per epoch end, train.py:75)."""
    if cfg.lr_policy == "lambda":
        lr_l = 1.0 - max(0, epoch + 1 + cfg.epoch_count - cfg.niter) \
            / float(cfg.niter_decay + 1)
        return cfg.lr * lr_l
    if cfg.lr_policy == "step":
        return cfg.lr * (0.1 ** (epoch // cfg.lr_decay_iters))
    raise NotImplementedError(
        f"learning rate policy [{cfg.lr_policy}] is not implemented")


class PlateauScheduler:
    """ReduceLROnPlateau(mode='min', factor=0.2, threshold=0.01, patience=5)."""

    def __init__(self, cfg):
        self.lr = cfg.lr
        self.best = float("inf")
        self.bad_epochs = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1 - 0.01):
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > 5:
                self.lr *= 0.2
                self.bad_epochs = 0
        return self.lr
