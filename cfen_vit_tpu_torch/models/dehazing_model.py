"""Generator wrapper for inference (counterpart of
cfen_vit_tpu/models/dehazing_model.py).

Batches arrive as NHWC from the data loader (data/) and travel to
the device as uint8; the forward normalises with x/127.5 - 1 and returns
uint8 through the reference's truncating tensor2im (`forward_u8`, which
the server calls directly).  Visuals are named real_B / fake_A / fake_R /
fake_S / fake_A_refined as in the reference; dec_ipt, which has no D
branch, names its refined output fake_A.  With --out_all a generator with
a D branch runs its d-only path and only fake_A comes back.

--self_ensemble and --chop (models/inference_utils.py) compose the float
forward, so under either flag the uint8 wire is off: set_input takes the
loader's [-1, 1] floats and the visuals come back as float32.  --chop
tiles at the configured input size with --chop_overlap and passes an
input of exactly that size through whole.

`--model` picks the generator as the JAX package's does
(`_MODEL_DEFAULT_G`): dec_vit and test run --model_G, the other five their
own spec.

Spans (utils/profiling.py): `infer.set_input`, and `infer.test` around
`infer.forward` (the forward's launch) and each `sync.to_host` (an
output's device-to-host read, counted in `syncs`), with the batch count
as their unit.
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
from ..utils.profiling import annotate, count

# --model -> its generator; None: --model_G (JAX dehazing_model.py:31-39)
_MODEL_DEFAULT_G = {
    "dec_vit": None,
    "decr_vit": "iidr_hlgvit_crs_gd4",
    "decs_vit": "iids_hlgvit_crs_gd4",
    "decn_vit": "iidn_hlgvit_crs_gd4",
    "vit": "ipt",
    "dec_mgvit": "dec_ipt",
    "test": None,
}

_VISUAL = {"d": "fake_A", "r": "fake_R", "s": "fake_S", "dh": "fake_A_refined"}


class DehazingModel:
    def __init__(self, cfg, device: torch.device):
        if cfg.model not in _MODEL_DEFAULT_G:
            raise NotImplementedError(
                f"--model {cfg.model}: the port runs "
                f"{sorted(_MODEL_DEFAULT_G)}")
        self.cfg = cfg
        self.device = device
        self.dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                      else torch.float32)
        self.spec = generator_spec(_MODEL_DEFAULT_G[cfg.model] or cfg.model_G,
                                   cfg)
        self.net = Generator(self.spec)
        # --out_all keeps only fake_A (ref test.py:47-55); a generator with
        # a D branch then skips the work only the other outputs need
        self.d_only = bool(cfg.out_all and "d" in self.spec.branches)
        self.branches = "d" if self.d_only else None
        self.outputs = (["d"] if self.d_only else list(self.spec.branches)
                        + (["dh"] if self.spec.xdh else []))
        self._u8_io = not (getattr(cfg, "chop", False)
                           or getattr(cfg, "self_ensemble", False))
        self.real_B = None
        self.image_paths = []
        self.batches = 0         # taken by set_input: the unit id of spans

    def setup(self, cfg=None) -> None:
        cfg = cfg or self.cfg
        epoch = cfg.which_epoch
        if epoch == "latest" and latest_epoch(cfg) and not _exists(cfg, epoch):
            epoch = latest_epoch(cfg)
        load_net(cfg, epoch, "G", self.net)
        self.net.to(device=self.device, dtype=self.dtype)
        self.net.eval().requires_grad_(False)

    def set_input(self, batch: Dict) -> None:
        self.batches += 1
        with annotate("infer.set_input", self.batches):
            self._set_input(batch["B"])
        self.image_paths = batch["B_paths"]

    def _set_input(self, b: np.ndarray) -> None:
        if self._u8_io:
            # rint recovers the pixels exactly from the loader's v/255*2-1
            u8 = b if b.dtype == np.uint8 else np.rint(
                (b + 1.0) * 127.5).astype(np.uint8)
            self.real_B = torch.from_numpy(u8).to(self.device)
        else:
            self.real_B = torch.from_numpy(np.ascontiguousarray(b)).to(
                self.device, self.dtype)

    def forward_u8(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """uint8 NHWC on the device -> {branch: uint8 NHWC on the device}."""
        x = x.permute(0, 3, 1, 2).contiguous().to(self.dtype)
        out = self.net(x / 127.5 - 1.0, branches=self.branches)
        return {b: ((v.float() + 1.0) * 127.5).to(torch.uint8).permute(0, 2, 3, 1)
                for b, v in out.items()}

    def _forward_float(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = self.net(x.permute(0, 3, 1, 2).contiguous(), branches=self.branches)
        return {b: v.permute(0, 2, 3, 1) for b, v in out.items()}

    def test(self, cfg=None) -> Dict[str, np.ndarray]:
        with annotate("infer.test", self.batches):
            return self._test(cfg or self.cfg)

    @torch.inference_mode()
    def _test(self, cfg) -> Dict[str, np.ndarray]:
        with annotate("infer.forward"):
            out = self._forward(cfg)
        visuals = {} if self.d_only else {"real_B": _host(self.real_B)}
        for b, v in out.items():
            # dec_ipt: the refined output is the dehazed image
            # (ref dec_mgvit_model.py:90, JAX dehazing_model.py:163-168)
            name = ("fake_A" if b == "dh" and "d" not in self.spec.branches
                    else _VISUAL[b])
            visuals[name] = _host(v)
        return visuals

    def _forward(self, cfg) -> Dict[str, torch.Tensor]:
        if self._u8_io:
            return self.forward_u8(self.real_B)
        fwd = self._forward_float
        if getattr(cfg, "self_ensemble", False):
            base = fwd

            def fwd(x, _base=base):
                return {b: self_ensemble_x8(lambda v, _b=b: _base(v)[_b], x)
                        for b in self.outputs}
        if getattr(cfg, "chop", False):
            tile, base = cfg.input_size(), fwd

            def fwd(x, _base=base):
                if x.shape[1] == tile and x.shape[2] == tile:
                    return _base(x)
                return {b: chop_forward(lambda v, _b=b: _base(v)[_b], x,
                                        tile, cfg.chop_overlap)
                        for b in self.outputs}
        return fwd(self.real_B)

    def get_image_paths(self):
        return self.image_paths


def create_model(cfg, device: Optional[torch.device] = None):
    """The trainer when cfg.isTrain, else the inference wrapper, for the
    seven `--model` values (JAX dehazing_model.py create_model); on
    `--gpu_ids`' device unless one is given."""
    if cfg.model not in _MODEL_DEFAULT_G:
        raise NotImplementedError(f"model [{cfg.model}] not implemented.")
    from ..config import select_device
    device = device if device is not None else select_device(cfg.gpu_ids)
    if cfg.isTrain:
        from ..train.trainer import GanTrainer
        return GanTrainer(cfg, device)
    return DehazingModel(cfg, device)


def _host(t: torch.Tensor) -> np.ndarray:
    """uint8 stays uint8; the float path comes back as float32."""
    with annotate("sync.to_host"):
        count("syncs")
        return (t if t.dtype == torch.uint8 else t.float()).cpu().numpy()


def _exists(cfg, epoch) -> bool:
    d = os.path.join(cfg.checkpoints_dir, cfg.name)
    return any(os.path.exists(os.path.join(d, f"{epoch}_net_G.{ext}"))
               for ext in ("pth", "msgpack"))
