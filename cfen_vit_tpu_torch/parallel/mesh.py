"""Data parallel over `--mesh_shape` (counterpart of
cfen_vit_tpu/parallel/mesh.py and the JAX trainer's mesh,
cfen_vit_tpu/train/trainer.py:165-172).

torch's idiom for the JAX package's 1-D `data` mesh: one process per
device, launched by torchrun (NCCL between cards, gloo on the CPU):

    torchrun --standalone --nproc_per_node 4 -m cfen_vit_tpu_torch.train \
        --mesh_shape 4 --batchSize 8 ...

  * `--batchSize` is the global batch, as in JAX; rank r trains on the
    contiguous shard [r * B / W, (r + 1) * B / W) of every batch (the
    loader decodes only that shard), and W must divide B;
  * `--mesh_shape ''` takes the launched world size (1 without torchrun);
    `'N'` needs a world of N processes and raises otherwise, as the JAX
    mesh's reshape does (parallel/mesh.py:31 there); a 2-D `'a,b'`
    raises: JAX's `model` axis only replicates (trainer.py:210-211, 485);
  * the step equals one device on the global batch: each rank's grads of
    G and of each D are mean-reduced over the ranks (`allreduce_mean_`,
    DistributedDataParallel's reduction: flattened buckets, a sum, a
    division by W), the ID-MRF term, which sums over the batch, is scaled
    by W before that mean, the ActNorm init pass and the ImagePool see the
    global batch (`gather`), and the reported losses are global means;
  * only rank 0 writes checkpoints, logs and the web page.

The trainer calls backward with `inputs=`, runs D through functional_call
and, in bfloat16, a compute copy of G whose grads it moves to the float32
masters: DDP's autograd hooks on a wrapped module see none of that, so
the step reduces the grads itself, once per step after the micro-batches.

`dryrun(n)` runs one GAN step on n gloo ranks at the JAX package's tiny
geometry in subprocesses (counterpart of __graft_entry__.dryrun_multichip).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from dataclasses import dataclass
from typing import Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    rank: int = 0
    size: int = 1
    local_rank: int = 0

    @property
    def launched(self) -> bool:
        """Under torchrun (or `dryrun`): the process group exists."""
        return dist.is_available() and dist.is_initialized()

    def shard(self, batch: int) -> slice:
        per = batch // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


def _env() -> tuple:
    return (int(os.environ.get("RANK", 0)), int(os.environ.get("WORLD_SIZE", 1)),
            int(os.environ.get("LOCAL_RANK", 0)))


def make_mesh(mesh_shape: str = "", batch_size: Optional[int] = None) -> Mesh:
    """The launched processes as the `data` mesh `mesh_shape` asks for;
    raises where they cannot be."""
    rank, size, local = _env()
    if mesh_shape:
        dims = [int(s) for s in mesh_shape.split(",")]
        if len(dims) > 1:
            raise NotImplementedError(
                f"--mesh_shape {mesh_shape}: a 2-D mesh; the port trains data "
                "parallel only (the JAX package's model axis replicates and "
                "shards nothing)")
        if dims[0] != size:
            raise ValueError(
                f"--mesh_shape {mesh_shape} asks for {dims[0]} devices, the "
                f"run has {size} process{'es' if size > 1 else ''}: launch "
                f"it with torchrun --nproc_per_node {dims[0]}")
    if batch_size is not None and batch_size % size:
        raise ValueError(f"--batchSize {batch_size} does not divide over "
                         f"{size} ranks")
    return Mesh(rank, size, local)


def current() -> Mesh:
    """The mesh of this process: its process group's, else one rank."""
    if dist.is_available() and dist.is_initialized():
        return Mesh(dist.get_rank(), dist.get_world_size(), _env()[2])
    return Mesh()


def device_for(mesh: Mesh, gpu_ids: str) -> torch.device:
    """`--gpu_ids -1` is the CPU on every rank; otherwise rank r of a
    launched run takes cuda:<local rank>, a lone process `--gpu_ids`'s
    card (config.select_device)."""
    from ..config import select_device
    device = select_device(gpu_ids)
    if device.type == "cuda" and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", mesh.local_rank)
    return device


def init(mesh: Mesh, device: torch.device) -> Mesh:
    """Joins the process group torchrun's environment names (NCCL on
    cards, gloo on the CPU); a process torchrun did not start stays
    alone."""
    if "WORLD_SIZE" not in os.environ or current().launched:
        return current()
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            rank=mesh.rank, world_size=mesh.size)
    return current()


def allreduce_mean_(tensors: Iterable[torch.Tensor]) -> None:
    """Each tensor replaced by its mean over the ranks, in place, one
    flattened all-reduce per dtype."""
    groups: dict = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    size = dist.get_world_size()
    for ts in groups.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat)
        flat /= size
        i = 0
        for t in ts:
            t.copy_(flat[i:i + t.numel()].view_as(t))
            i += t.numel()


def gather(x: torch.Tensor) -> torch.Tensor:
    """The ranks' [b, ...] tensors joined in rank order: the global batch."""
    parts: List[torch.Tensor] = [torch.empty_like(x)
                                 for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


# --------------------------------------------------------------------------
# the dryrun
# --------------------------------------------------------------------------

TINY = dict(n_feats=8, loadSize=64, patch_size=8, num_heads=2,
            hidden_dim_ratio=2)
SIZE = 128   # 2x the tiny trunk (half-res v3)


def tiny_batch(n: int, seed: int = 7) -> dict:
    """The JAX dryrun's kind of batch: n random images a key, on the
    uint8 grid (the trainer's wire)."""
    r = np.random.RandomState(seed)
    out = {k: (r.randint(0, 256, (n, SIZE, SIZE, 1 if k == "S" else 3))
               .astype(np.float32) / 127.5 - 1.0) for k in "BARS"}
    out["B_paths"] = [f"{i}.png" for i in range(n)]
    return out


def tiny_trainer(n: int, mesh_shape: str, tmp: str):
    """A GanTrainer at the JAX dryrun's geometry (pool 2, remat off) on
    the CPU, global batch n."""
    from ..config import parse_args
    from ..train.trainer import GanTrainer
    argv = ["--name", "dryrun", "--checkpoints_dir", tmp, "--gpu_ids", "-1",
            "--batchSize", str(n), "--pool_size", "2", "--no_remat", "--sb",
            "--mesh_shape", mesh_shape]
    for k, v in TINY.items():
        argv += [f"--{k}", str(v)]
    return GanTrainer(parse_args(argv, save_opt=False), torch.device("cpu"))


def step_record(tr) -> dict:
    """What a step leaves: the losses, G and D, Adam's first moments (the
    mean-reduced grads x 0.1 after one step) and the pools."""
    def moments(opt):
        return [opt.state[p]["exp_avg"].clone() for group in opt.param_groups
                for p in group["params"]]
    return {"losses": tr.get_current_losses(), "g": tr.g.state_dict(),
            "d": tr.d.state_dict(), "g_m": moments(tr.g_opt),
            "d_m": moments(tr.d_opt),
            "pools": {k: p["buf"].clone() for k, p in tr.pools.items()}}


def _dryrun_rank(n: int, out: Optional[str]) -> None:
    import tempfile
    mesh = init(make_mesh(str(n), n), torch.device("cpu"))
    with tempfile.TemporaryDirectory() as tmp:
        tr = tiny_trainer(n, str(n), tmp)
        batch = tiny_batch(n)
        tr.set_input({k: v[mesh.shard(n)] for k, v in batch.items()})
        tr.optimize_parameters()
    losses = tr.get_current_losses()
    if not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"dryrun({n}): non-finite losses {losses}")
    if mesh.rank == 0:
        print(f"dryrun({n}) ok: G={losses['G']:.3f} ranks={mesh.size}",
              flush=True)
        if out:
            torch.save(step_record(tr), out)
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun(n: int, out: Optional[str] = None, timeout: float = 600) -> str:
    """One GAN step of the tiny v3 trainer on n gloo ranks (n processes on
    the CPU, global batch n), losses finite; rank 0 saves its losses,
    weights and pools to `out` when given.  Returns rank 0's output."""
    env = dict(os.environ, MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(n),
               OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)   # the children import no JAX
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs = []
    for r in range(n):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "cfen_vit_tpu_torch.parallel.mesh",
             str(n), json.dumps(out)],
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=repo,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise RuntimeError(f"dryrun({n}) failed on ranks {bad}:\n"
                           + "\n".join(o[-2000:] for o in outputs))
    return outputs[0]


if __name__ == "__main__":
    _dryrun_rank(int(sys.argv[1]), json.loads(sys.argv[2]))
