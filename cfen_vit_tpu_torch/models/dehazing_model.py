"""Generator wrapper for inference (counterpart of
cfen_vit_tpu/models/dehazing_model.py).

Batches arrive as NHWC from the data loader (data/) and travel to
the device as uint8; the forward normalises with x/127.5 - 1 and returns
uint8 through the reference's truncating tensor2im (`forward_u8`, which
the server calls directly).  Visuals are named real_B / fake_A / fake_R /
fake_S as in the reference.  With --out_all the generator runs its d-only
path and only fake_A comes back.

--self_ensemble and --chop (models/inference_utils.py) compose the float
forward, so under either flag the uint8 wire is off: set_input takes the
loader's [-1, 1] floats and the visuals come back as float32.  --chop
tiles at the configured input size with --chop_overlap and passes an
input of exactly that size through whole.

Ported: `--model` dec_vit and test with the v3 generator.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from .generator import Generator
from .inference_utils import chop_forward, self_ensemble_x8
from .registry import generator_spec
from ..train.checkpoint import latest_epoch, load_net

_VISUAL = {"d": "fake_A", "r": "fake_R", "s": "fake_S"}


class DehazingModel:
    def __init__(self, cfg, device: torch.device):
        if cfg.model not in ("dec_vit", "test"):
            raise NotImplementedError(
                f"--model {cfg.model}: the port runs dec_vit and test "
                "(ROADMAP Queue A items 6 and 8)")
        self.cfg = cfg
        self.device = device
        self.dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                      else torch.float32)
        self.spec = generator_spec(cfg.model_G, cfg)
        self.net = Generator(self.spec)
        # --out_all keeps only fake_A (ref test.py:47-55); the generator
        # then skips the work only R and S outputs need
        self.branches = "d" if cfg.out_all else "rsd"
        self._u8_io = not (getattr(cfg, "chop", False)
                           or getattr(cfg, "self_ensemble", False))
        self.real_B = None
        self.image_paths = []

    def setup(self, cfg=None) -> None:
        cfg = cfg or self.cfg
        epoch = cfg.which_epoch
        if epoch == "latest" and latest_epoch(cfg) and not _exists(cfg, epoch):
            epoch = latest_epoch(cfg)
        load_net(cfg, epoch, "G", self.net)
        self.net.to(device=self.device, dtype=self.dtype)
        self.net.eval().requires_grad_(False)

    def set_input(self, batch: Dict) -> None:
        b = batch["B"]
        if self._u8_io:
            # rint recovers the pixels exactly from the loader's v/255*2-1
            u8 = b if b.dtype == np.uint8 else np.rint(
                (b + 1.0) * 127.5).astype(np.uint8)
            self.real_B = torch.from_numpy(u8).to(self.device)
        else:
            self.real_B = torch.from_numpy(np.ascontiguousarray(b)).to(
                self.device, self.dtype)
        self.image_paths = batch["B_paths"]

    def forward_u8(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """uint8 NHWC on the device -> {branch: uint8 NHWC on the device}."""
        x = x.permute(0, 3, 1, 2).contiguous().to(self.dtype)
        out = self.net(x / 127.5 - 1.0, branches=self.branches)
        return {b: ((v.float() + 1.0) * 127.5).to(torch.uint8).permute(0, 2, 3, 1)
                for b, v in out.items()}

    def _forward_float(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = self.net(x.permute(0, 3, 1, 2).contiguous(), branches=self.branches)
        return {b: v.permute(0, 2, 3, 1) for b, v in out.items()}

    @torch.inference_mode()
    def test(self, cfg=None) -> Dict[str, np.ndarray]:
        cfg = cfg or self.cfg
        if self._u8_io:
            out = self.forward_u8(self.real_B)
        else:
            fwd = self._forward_float
            if getattr(cfg, "self_ensemble", False):
                base = fwd

                def fwd(x, _base=base):
                    return {b: self_ensemble_x8(lambda v, _b=b: _base(v)[_b], x)
                            for b in self.branches}
            if getattr(cfg, "chop", False):
                tile, base = cfg.input_size(), fwd

                def fwd(x, _base=base):
                    if x.shape[1] == tile and x.shape[2] == tile:
                        return _base(x)
                    return {b: chop_forward(lambda v, _b=b: _base(v)[_b], x,
                                            tile, cfg.chop_overlap)
                            for b in self.branches}
            out = fwd(self.real_B)
        visuals = {} if self.branches == "d" else {"real_B": _host(self.real_B)}
        for b, v in out.items():
            visuals[_VISUAL[b]] = _host(v)
        return visuals

    def get_image_paths(self):
        return self.image_paths


def create_model(cfg, device: Optional[torch.device] = None):
    """The trainer when cfg.isTrain, else the inference wrapper; on
    `--gpu_ids`' device unless one is given."""
    from ..config import select_device
    device = device if device is not None else select_device(cfg.gpu_ids)
    if cfg.isTrain:
        from ..train.trainer import GanTrainer
        return GanTrainer(cfg, device)
    return DehazingModel(cfg, device)


def _host(t: torch.Tensor) -> np.ndarray:
    """uint8 stays uint8; the float path comes back as float32."""
    return (t if t.dtype == torch.uint8 else t.float()).cpu().numpy()


def _exists(cfg, epoch) -> bool:
    d = os.path.join(cfg.checkpoints_dir, cfg.name)
    return any(os.path.exists(os.path.join(d, f"{epoch}_net_G.{ext}"))
               for ext in ("pth", "msgpack"))
