"""Conditional-GAN trainer (counterpart of cfen_vit_tpu/train/trainer.py;
the reference's DECHLGVIT, model_iid_dehazing.py, and its MGVIT and
DECMGVIT wrappers) for every `--model`.

The generator is `--model`'s own spec where it has one, else `--model_G`
(`models/dehazing_model.py _MODEL_DEFAULT_G`).  Branches and their D: d
is A (a spec without d but with the xdh refiner trains its refined dh as
A: dec_ipt), r is R, s is S; one discriminator per mapped branch.

One `optimize_parameters` per batch, in the JAX package's order:
  1. generator forward and the G loss, grads of G only;
  2. the ImagePool advances with the current fakes, and its query result
     is discarded (the reference's backward_D builds fake_*_cat from the
     current fakes, ref :173-187), so D trains on un-pooled fakes;
  3. the LS-GAN D loss 0.5 (real + fake) on the current fakes, grads of D
     only; both losses use the parameters from before the step;
  4. the skip gate: isfinite(G) and G < --skip_threshold, else neither
     network, no Adam moment or step count and no pool changes;
  5. Adam (beta1 --beta1, beta2 0.999, eps 1e-8) on G and on the Ds
     jointly, at lr_for_epoch.

G loss sets:
  * dec_vit, decr_vit, decs_vit, decn_vit, test: per branch (S expanded
    1 -> 3 channels) GAN x0.0618, VGG x2 lambda_vgg, gradient MSE x2, L1
    x2, (1 - SSIM) x3; on A only ID-MRF x0.06 and semantic consistency
    x2, both called as (real, fake) as the reference does (the losses are
    asymmetric);
  * vit (MGVIT, ref mgvit_model.py:90-123): A only, GAN x0.0618, VGG x2
    lambda_vgg, gradient MSE x0.2, L1 x3 under the keys GAN, vgg,
    gradient_fake_A, L1; summed in the compute dtype, as JAX does;
  * dec_mgvit (DECMGVIT, ref dec_mgvit_model.py:141-182): per branch GAN
    x0.0618, VGG x2 lambda_vgg, gradient MSE x1, L1 x2.

--grad_accum N splits the batch into N micro-batches of batchSize / N, in
order; each runs its G loss and backward, then its D loss and backward,
on the parameters from before the step, and its graph is freed before
the next one starts.  Grads are the mean over the micro-batches, summed
in float32 on the masters; the losses are their means (ID-MRF is
sum-normalised, so its term comes out scaled by 1 / N, as in JAX); the
visuals are the last micro-batch's fakes; the skip gate reads the mean G
loss once.  The pools take the micro-batches' fakes after the gate, in
order, which leaves them as a query after each micro-batch would (their
answer is discarded and they draw from their own generator).

--compute_dtype bfloat16: float32 master parameters and moments.  The G
loss runs a bf16 copy of the generator whose parameters are refreshed
from the masters every step (a checkpointed region recomputes with the
module's own parameters, so torch.func.functional_call cannot stand in
for them there), and its grads are cast back to float32, which is what
JAX's cast gives; the ActNorm `initialized` buffers are not cast.  The D
and VGG parameters enter the G loss cast to bf16 (functional_call,
without grad: the G loss differentiates G only).  The D loss runs in
float32 on the float32 D, as JAX's type promotion makes it there.  The
ActNorms are initialised from the whole first batch in float32 before
the first step.
Data parallel (`--mesh_shape`, parallel/mesh.py): `set_input` takes this
rank's shard of the global batch; the grads of G and the Ds and the
losses are mean-reduced over the ranks before the skip gate, the ID-MRF
term (a sum over the batch) is scaled by the world size first, and the
ActNorm init pass and the pools take the global batch; only rank 0 saves.
Batches travel as uint8 when that is lossless and are normalised on the
device.  Pools are device ring buffers in the compute dtype, updated in
place, sampled by a torch.Generator.

On a card the step replays one CUDA graph where it can: with one
micro-batch, one process, after the first step (ActNorms initialised,
pools made), for a batch that came through `set_input`.  The first such
step captures the region from the wire's normalisation through the
compute copy's refresh, the G loss and backward (grads cast onto the
masters), the D loss and backward, the zero grads and the stacked
losses, for its batch signature (keys, shapes and dtypes on the wire);
later batches of that signature are copied into the graph's static
arrays and replay it.  The skip gate, the pools, Adam and the learning
rate stay eager, after the replay.  A batch of another signature, the
CPU, --grad_accum > 1 and --mesh_shape run the eager step.  The replay
writes the static grads the eager Adam reads: they are set as .grad
after each replay and never accumulated into; the losses, fakes and
batch the wrapper returns are the graph's static tensors, which hold
the step's values until the next step.

Spans (utils/profiling.py, which lists them): `train.set_input` and
`train.step` with a span for each phase of the step (a replayed step:
`train.graph_replay` in place of the phases it captured), `sync.*`
around each read of a device value (counted in `syncs`), the batch
count as their unit; the counters `graph_captures`, `graph_replays`.
"""

from __future__ import annotations

import copy
import math
from typing import Dict

import numpy as np
import torch
from torch.func import functional_call

from ..losses.gan import gan_loss
from ..losses.vgg import (idmrf_loss, semantic_consistency_loss, vgg19_init,
                          vgg_perceptual_loss)
from ..models.dehazing_model import _MODEL_DEFAULT_G
from ..models.discriminator import apply_d, define_d
from ..models.generator import Generator, init_weights
from ..models.registry import generator_spec
from ..ops.gradient import color_gradient
from ..ops.ssim import ssim
from ..parallel import mesh as M
from ..utils.profiling import annotate, count
from .checkpoint import load_train_state, save_net, save_train_state
from .schedule import lr_for_epoch

_VISUAL = {"A": "fake_A", "R": "fake_R", "S": "fake_S"}
def _u8_wire(v: np.ndarray) -> np.ndarray:
    """float [-1,1] -> uint8 iff exactly recoverable (loader floats are
    u8 / 127.5 - 1); other arrays pass unchanged."""
    if v.dtype != np.float32 or v.ndim != 4:
        return v
    u8 = np.rint((v + 1.0) * 127.5)
    if u8.min() < 0 or u8.max() > 255:
        return v
    u8 = u8.astype(np.uint8)
    if np.array_equal(u8.astype(np.float32) / 127.5 - 1.0, v):
        return u8
    return v


def host_wire(batch: Dict) -> Dict[str, np.ndarray]:
    """The NHWC numpy arrays of a loader batch as they cross to the device:
    uint8 where that is lossless (`_u8_wire`), else as they are."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            with annotate("train.set_input.wire"):
                out[k] = _u8_wire(v)
    return out


def signature(wire: Dict[str, np.ndarray]) -> tuple:
    """A batch's keys, shapes and dtypes on the wire."""
    return tuple(sorted((k, v.shape, v.dtype.str) for k, v in wire.items()))


def copy_in(wire: Dict[str, np.ndarray], device, into=None
            ) -> Dict[str, torch.Tensor]:
    """The wire's arrays on the device, each a pageable copy: new tensors,
    or the tensors of `into` (same keys, shapes and dtypes) overwritten."""
    out = {}
    for k, v in wire.items():
        with annotate("train.set_input.copy"):
            src = torch.from_numpy(v)
            out[k] = src.to(device) if into is None else into[k].copy_(src)
    return out


def normalise(t: torch.Tensor) -> torch.Tensor:
    """A device array of the wire, NHWC -> NCHW in [-1, 1]: uint8 to
    float32; other arrays keep their float dtype."""
    t = t.permute(0, 3, 1, 2).contiguous()
    return (t.float() / 127.5 - 1.0 if t.dtype == torch.uint8
            else t if t.is_floating_point() else t.float())


# --------------------------------------------------------------------------
# device-side ImagePool
# --------------------------------------------------------------------------

def pool_init(pool_size: int, shape, dtype=torch.float32, device=None) -> Dict:
    """Ring buffer of `pool_size` images [C, H, W] plus one scratch row
    (index pool_size) that takes the write of an image that is not kept."""
    rows = pool_size + 1 if pool_size > 0 else 0
    return {"buf": torch.zeros((rows,) + tuple(shape), dtype=dtype,
                               device=device), "n": 0}


@torch.no_grad()
def pool_query(pool: Dict, images: torch.Tensor, gen: torch.Generator):
    """The reference's util/image_pool.py:12-31, image by image: below
    capacity store and return the image; else with p = 0.5 swap it with a
    random slot and return the old one, or return it unchanged.  Updates
    `pool` in place and returns (pool, outputs)."""
    size = pool["buf"].shape[0] - 1
    if size <= 0:
        return pool, images
    buf = pool["buf"]
    outs = []
    for img in images.to(buf.dtype):
        p = torch.rand((), generator=gen).item()
        rid = int(torch.randint(0, size, (), generator=gen))
        if pool["n"] < size:
            buf[pool["n"]] = img
            pool["n"] += 1
            outs.append(img)
        elif p > 0.5:
            outs.append(buf[rid].clone())
            buf[rid] = img
        else:
            buf[size] = img
            outs.append(img)
    return pool, torch.stack(outs)


# --------------------------------------------------------------------------
# trainer
# --------------------------------------------------------------------------

class _StepGraph:
    """A step captured by GanTrainer._capture for one batch signature: the
    static device arrays set_input copies the wire into, the CUDA graph,
    and the static tensors each replay writes (the normalised batch, the
    losses, each micro-batch's fakes, every parameter's grad in the
    optimizers' order)."""

    def __init__(self, signature: tuple, inputs: Dict[str, torch.Tensor]):
        self.signature = signature
        self.inputs = inputs
        self.graph = torch.cuda.CUDAGraph()
        self.batch: Dict[str, torch.Tensor] = {}
        self.losses: Dict[str, torch.Tensor] = {}
        self.fakes: list = []
        self.grads: list = []


class GanTrainer:
    """The reference wrapper's interface: set_input / optimize_parameters /
    get_current_losses / get_current_visuals / save_networks /
    update_learning_rate."""

    def __init__(self, cfg, device: torch.device):
        self.cfg = cfg
        self.device = device
        self.dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                      else torch.float32)
        self.spec = generator_spec(_MODEL_DEFAULT_G.get(cfg.model)
                                   or cfg.model_G, cfg)
        self.loss_set = {"vit": "mgvit", "dec_mgvit": "decmgvit"}.get(
            cfg.model, "dec")
        self.accum = max(1, int(cfg.grad_accum))
        self.mesh = M.init(M.make_mesh(cfg.mesh_shape, cfg.batchSize), device)
        if (cfg.batchSize // self.mesh.size) % self.accum:
            raise ValueError(f"--grad_accum {self.accum} does not divide the "
                             f"per-rank batch {cfg.batchSize // self.mesh.size}")
        # generator output -> fake name; dec_ipt has no d, so its refined
        # dh is A (ref dec_mgvit_model.py:90)
        self.branches = {"d" if "d" in self.spec.branches else "dh": "A"}
        self.branches.update({b: b.upper() for b in "rs"
                              if b in self.spec.branches})
        self.use_lsgan = not cfg.no_lsgan
        self.remat = (cfg.remat_mode or "level") if cfg.remat else "none"
        gen = torch.Generator().manual_seed(int(cfg.seed))
        self.g = init_weights(Generator(self.spec), gen).to(device)
        self.d = torch.nn.ModuleDict(
            {name: define_d(cfg, gen) for name in self.branches.values()}
        ).to(device)
        # a fixed seed, not --seed, as the JAX package's PRNGKey(1234): the
        # tower is not in the checkpoints
        self.vgg = vgg19_init(cfg.vgg19_npz or None).to(device, self.dtype)
        adam = dict(betas=(cfg.beta1, 0.999), eps=1e-8)
        self.g_opt = torch.optim.Adam(self.g.parameters(), lr=0.0, **adam)
        self.d_opt = torch.optim.Adam(self.d.parameters(), lr=0.0, **adam)
        self._g_c = None         # the bf16 compute copy of G
        self.pool_gen = torch.Generator().manual_seed(int(cfg.seed) + 1)
        self.pools: Dict[str, Dict] = {}
        self.step = 0
        self.epoch = cfg.epoch_count
        self.lr = lr_for_epoch(cfg, 0)
        self._batch: Dict[str, torch.Tensor] = {}
        # set_input's (signature, device wire arrays, batch), which a capture
        # reads; `_batch` set by other code runs the eager step
        self._input: tuple = ((), {}, None)
        self._graph = None       # the captured step (_StepGraph)
        self.batches = 0         # taken by set_input: the unit id of spans
        self._losses: Dict[str, torch.Tensor] = {}
        self._fakes: Dict[str, torch.Tensor] = {}
        self.image_paths = []

    def networks(self) -> Dict[str, torch.nn.Module]:
        """The checkpointed networks by slot name (`<epoch>_net_<name>`)."""
        return {"G": self.g, **{f"D_{k}": d for k, d in self.d.items()}}

    def load_state_dicts(self, g=None, d=None, vgg=None) -> None:
        """Start from given weights: a generator state_dict, {A/R/S: D
        state_dict}, a VGG19 state_dict."""
        if g is not None:
            self.g.load_state_dict(g, strict=True)
        for name, sd in (d or {}).items():
            self.d[name].load_state_dict(sd, strict=True)
        if vgg is not None:
            self.vgg.load_state_dict(vgg, strict=True)

    def setup(self, cfg=None) -> None:
        cfg = cfg or self.cfg
        if cfg.continue_train:
            st = load_train_state(cfg, cfg.which_epoch, self.device)
            self.load_state_dicts(st["g"], st["d"])
            self.g_opt.load_state_dict(st["g_opt"])
            self.d_opt.load_state_dict(st["d_opt"])
            self.pool_gen.set_state(st["pool_gen"])
            self.step = int(st["step"])

    # -- losses -------------------------------------------------------------
    def _cast(self, module: torch.nn.Module) -> Dict[str, torch.Tensor]:
        """module's parameters in the compute dtype, without grad, and its
        buffers as they are, for functional_call."""
        state = {k: p.detach().to(self.dtype)
                 for k, p in module.named_parameters()}
        state.update(module.named_buffers())
        return state

    def _g_compute(self) -> Generator:
        """The generator the G loss runs: the master in float32; in bf16 a
        copy refreshed from the masters."""
        if self.dtype == torch.float32:
            return self.g
        if self._g_c is None:
            self._g_c = copy.deepcopy(self.g).to(self.dtype)
        with annotate("train.g_refresh"), torch.no_grad():
            for pc, pm in zip(self._g_c.parameters(), self.g.parameters()):
                pc.copy_(pm)
        return self._g_c

    def _g_loss(self, g, batch):
        cfg = self.cfg
        batch = {k: v.to(self.dtype) for k, v in batch.items()}
        with annotate("train.g_forward"):
            out = g(batch["B"], remat=self.remat)
        fakes = {name: out[b] for b, name in self.branches.items()}
        reals = {name: batch[name] for name in fakes}
        if "S" in fakes:
            fakes["S"] = fakes["S"].expand(-1, 3, -1, -1)
            reals["S"] = reals["S"].expand(-1, 3, -1, -1)
        hazy = batch["B"]
        losses = {}
        for name, fake in fakes.items():
            real, lk = reals[name], name.lower()
            with annotate("train.d_on_fake"):
                pred = functional_call(self.d[name], self._cast(self.d[name]),
                                       (torch.cat([hazy, fake], dim=1),))
                gan = gan_loss(pred, True, self.use_lsgan) * 0.0618
            with annotate("train.vgg"):
                vgg = (vgg_perceptual_loss(self.vgg, fake, real)
                       * cfg.lambda_vgg * 2)
            grad = torch.mean(torch.square(color_gradient(real)
                                           - color_gradient(fake)))
            l1 = torch.mean(torch.abs(real - fake))
            if self.loss_set == "mgvit":   # A is its only branch
                losses.update(GAN=gan, vgg=vgg, gradient_fake_A=grad * 0.2,
                              L1=l1 * 3)
                continue
            losses[f"GAN_{lk}"] = gan
            losses[f"vgg_{lk}"] = vgg
            losses[f"gradient_fake_{lk}"] = grad * (
                1 if self.loss_set == "decmgvit" else 2)
            losses[f"L2_{lk}"] = l1 * 2
            if self.loss_set == "dec":
                with annotate("train.ssim"):
                    losses[f"ssim_{lk}"] = (1.0 - ssim(real, fake)) * 3
        if self.loss_set == "dec":
            # a sum over the batch: the ranks' mean of W x their sums is
            # the global batch's sum
            with annotate("train.vgg"):
                losses["p"] = idmrf_loss(self.vgg, reals["A"], fakes["A"]) * (
                    0.06 * self.mesh.size)
                losses["s"] = semantic_consistency_loss(
                    self.vgg, reals["A"], fakes["A"]) * 2
        # JAX casts the terms to float32 before their sum, but MGVIT's, which
        # it sums in the compute dtype
        if self.loss_set != "mgvit":
            losses = {k: v.float() for k, v in losses.items()}
        losses["G"] = sum(losses.values())
        return {k: v.float() for k, v in losses.items()}, fakes, reals

    def _d_loss(self, hazy, fakes, reals):
        losses = {}
        for name, fake in fakes.items():
            real_cat = torch.cat([hazy, reals[name].float()], dim=1)
            fake_cat = torch.cat([hazy, fake.detach().float()], dim=1)
            l_real = gan_loss(apply_d(self.d[name], real_cat), True,
                              self.use_lsgan)
            l_fake = gan_loss(apply_d(self.d[name], fake_cat), False,
                              self.use_lsgan)
            losses[f"D{name}"] = (l_real + l_fake) * 0.5
        return losses

    # -- the step -----------------------------------------------------------
    def set_input(self, batch: Dict) -> None:
        """The batch on the device: into the captured step's static arrays
        when the step will replay it (normalised by the replay, which
        fills `_batch`), else normalised now."""
        self.batches += 1
        with annotate("train.set_input", self.batches):
            wire = host_wire(batch)
            sig = signature(wire)
            graph = (self._graph if self._graph is not None
                     and self._graph_engages(sig) else None)
            dev = copy_in(wire, self.device,
                          graph.inputs if graph is not None else None)
            self._batch = (graph.batch if graph is not None
                           else {k: normalise(v) for k, v in dev.items()})
            self._input = (sig, dev, self._batch)
        self.image_paths = batch.get("B_paths", [])

    @torch.no_grad()
    def _init_state(self, x: torch.Tensor) -> None:
        """Data-dependent ActNorm init from the first batch (float32, all
        branches, no remat; the global batch under data parallel); pools
        shaped after it."""
        if not self.g.actnorms_ready():
            self.g(M.gather(x) if self.mesh.launched else x)
        for name in self.branches.values():
            self.pools[name] = pool_init(self.cfg.pool_size, x.shape[1:],
                                         self.dtype, self.device)

    def _micro_step(self, g_c, batch, g_grads):
        """One micro-batch: G loss and backward, D loss and backward (the
        grads of G and D accumulate on their .grad; a compute copy's G
        grads are moved into the float32 list `g_grads`).  Returns the
        detached losses and fakes; the graph is gone when it returns."""
        with annotate("train.g_loss"):
            losses, fakes, reals = self._g_loss(g_c, batch)
        with annotate("train.g_backward"):
            losses["G"].backward(inputs=list(g_c.parameters()))
            if g_c is not self.g:
                for i, pc in enumerate(g_c.parameters()):
                    if pc.grad is not None:
                        g_grads[i] = (pc.grad.float() if g_grads[i] is None
                                      else g_grads[i].add_(pc.grad))
                        pc.grad = None
        with annotate("train.d_step"):
            d_losses = self._d_loss(batch["B"], fakes, reals)
            sum(d_losses.values()).backward(inputs=list(self.d.parameters()))
        losses.update(d_losses)
        return ({k: v.detach() for k, v in losses.items()},
                {k: v.detach() for k, v in fakes.items()})

    def _params(self) -> list:
        return [p for opt in (self.g_opt, self.d_opt)
                for group in opt.param_groups for p in group["params"]]

    def _grads(self, g_c, batch):
        """Every micro-batch's G and D losses and backward.  Leaves the
        mean grads on the masters' and the Ds' .grad, zeros where none
        reached; returns the mean losses and each micro-batch's fakes."""
        g_grads = [None] * len(self.g_opt.param_groups[0]["params"])
        mb = batch["B"].shape[0] // self.accum
        steps = [self._micro_step(g_c, {k: v[i * mb:(i + 1) * mb]
                                        for k, v in batch.items()}, g_grads)
                 for i in range(self.accum)]
        losses = {k: torch.stack([l[k] for l, _ in steps]).mean()
                  for k in steps[0][0]}
        if g_c is not self.g:
            for pm, acc in zip(self.g.parameters(), g_grads):
                pm.grad = acc
        for p in self._params():        # every parameter moves, as in JAX
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            elif self.accum > 1:
                p.grad /= self.accum
        return losses, [fakes for _, fakes in steps]

    def _region(self, wire):
        """What the captured step replays: the wire's normalisation, the
        compute copy's refresh, `_grads`.  Returns (batch, losses, fakes)."""
        batch = {k: normalise(v) for k, v in wire.items()}
        return (batch, *self._grads(self._g_compute(), batch))

    def _graph_engages(self, sig: tuple) -> bool:
        """Whether the step on a batch of signature `sig` replays the
        captured step (capturing it first if there is none): on a card,
        one micro-batch, one process, after the first step (ActNorms
        initialised, pools made), and `sig` the captured signature."""
        return (self.device.type == "cuda" and self.accum == 1
                and not self.mesh.launched and bool(self.pools)
                and self.g.actnorms_ready()
                and (self._graph is None or self._graph.signature == sig))

    def _capture(self, sig: tuple, wire) -> _StepGraph:
        """`_region` as a CUDA graph on static copies of the wire.  The
        eager first step has set up what is made lazily (kernels built,
        cuDNN's plans, ActNorm flags read, the ImageNet mean), so the
        capture needs no warm-up run of its own.  The grads are None at the
        capture, so its backward writes them rather than adding to them."""
        count("graph_captures")
        graph = _StepGraph(sig, {k: v.clone() for k, v in wire.items()})
        params = self._params()
        with torch.cuda.graph(graph.graph):
            graph.batch, graph.losses, graph.fakes = self._region(graph.inputs)
        graph.grads = [p.grad for p in params]
        for p in params:
            p.grad = None
        return graph

    def optimize_parameters(self, cfg=None) -> None:
        with annotate("train.step", self.batches):
            self._optimize()

    def _optimize(self) -> None:
        sig, wire, loaded = self._input
        if (self._graph is None and loaded is self._batch
                and self._graph_engages(sig)):
            self._graph = self._capture(sig, wire)
            self._batch = self._graph.batch
        graph = self._graph
        params = self._params()
        if graph is not None and self._batch is graph.batch:
            with annotate("train.graph_replay"):
                graph.graph.replay()
                count("graph_replays")
            for p, grad in zip(params, graph.grads):
                p.grad = grad
            losses, fakes = graph.losses, graph.fakes
        else:
            if not self.pools:
                self._init_state(self._batch["B"])
            losses, fakes = self._grads(self._g_compute(), self._batch)
        if self.mesh.launched:
            with annotate("train.allreduce"):
                M.allreduce_mean_([p.grad for p in params]
                                  + list(losses.values()))
        with annotate("sync.skip_gate"):
            gl = float(losses["G"])
            count("syncs")
        if math.isfinite(gl) and gl < float(self.cfg.skip_threshold):
            with annotate("train.pool"), torch.no_grad():
                for micro in fakes:
                    for name, fake in micro.items():
                        pool_query(self.pools[name], M.gather(fake)
                                   if self.mesh.launched else fake,
                                   self.pool_gen)
            with annotate("train.adam"):
                for opt in (self.g_opt, self.d_opt):
                    for group in opt.param_groups:
                        group["lr"] = self.lr
                    opt.step()
            self.step += 1
        with annotate("train.zero_grad"):
            for module in (self.g, self.d):
                module.zero_grad(set_to_none=True)
        self._losses = losses
        self._fakes = fakes[-1]

    # -- the reference wrapper's interface --------------------------------
    def get_current_losses(self) -> Dict[str, float]:
        with annotate("sync.losses", self.batches):
            count("syncs", len(self._losses))
            return {k: float(v) for k, v in self._losses.items()}

    def get_current_visuals(self) -> Dict[str, np.ndarray]:
        def nhwc(t):
            count("syncs")
            return t.float().permute(0, 2, 3, 1).cpu().numpy()
        with annotate("sync.visuals", self.batches):
            vis = {"real_B": nhwc(self._batch["B"])}
            for name, fake in self._fakes.items():
                vis[_VISUAL[name]] = nhwc(fake)
                if name in self._batch:
                    vis[f"real_{name}"] = nhwc(self._batch[name])
        return vis

    def get_image_paths(self):
        return self.image_paths

    def save_networks(self, epoch) -> None:
        if self.mesh.rank:
            return
        for name, net in self.networks().items():
            save_net(self.cfg, epoch, name, net)
        save_train_state(self.cfg, str(epoch), {
            "g": self.g.state_dict(),
            "d": {name: d.state_dict() for name, d in self.d.items()},
            "g_opt": self.g_opt.state_dict(), "d_opt": self.d_opt.state_dict(),
            "pool_gen": self.pool_gen.get_state(), "step": self.step})

    def update_learning_rate(self) -> None:
        self.epoch += 1
        old = self.lr
        self.lr = lr_for_epoch(self.cfg, self.epoch - self.cfg.epoch_count)
        print(f"learning rate = {self.lr:.7f} (was {old:.7f})")
