"""K5: flash-MRF, the ID-MRF divergence core on L2-normalised VGG features
(counterpart of cfen_vit_tpu/ops/pallas_mrf.py).

Replaces the TPU kernels `_mrf_forward_stats` (forward statistics) and
`_mrf_backward` (the do and dt cotangents) with three kernels of
csrc/mrf.cu that never hold the [P, P] matrix in device memory.  Per batch
row n, for o, t [N, P, C] with cos = o t^T summed in float32:

  cd = max(0.5 - 0.5 cos, 0)       m[q] = min_p cd, p*[q] its first argmin
  be = exp(2 - 2 cd / (m + 1e-5))  z[q] = sum_p be,  cs = be / z
  K[p] = max_q cs, q*[p] its first argmax
  loss = sum_n -log(mean_p K)

The kernels are bound by operations (2 N P^2 C multiply-adds for the
forward, twice that for each backward kernel).  All three form their cos
tiles with one sequence of tensor-core products (bf16 directly, float32
through a 3xTF32 split), so the backward's masks agree with the forward's
statistics bit for bit; do and dt run their dcos product on the tensor
cores too, from the same staged rows (the float32 dcos split into bf16 hi
+ lo, or 3xTF32); see the source's header.

`mrf_core(o_n, t_n)` is what losses/vgg.py calls: a CPU tensor takes
`mrf_core_plain`, the blocked dense form of the JAX `_mrf`, under
autograd; a CUDA tensor takes `MrfCore`, whose forward and backward run
the kernels.  Each kernel has a plain twin with its signature
(`mrf_forward_stats_plain`, `mrf_bwd_do_plain`, `mrf_bwd_dt_plain`); the
kernel wrappers run the twin for CPU tensors, so `MrfCore`'s glue runs on
the CPU in the tests, and chip_smoke.py holds each kernel against its twin
on the card.  A CUDA input the kernels do not take raises.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from . import _build

EPS = 1e-5
CHANNELS = (128, 256, 512)   # the kernels' instantiations (csrc/mrf.cu)
# kernel launches since the last reset, per kernel
fwd_launches = 0
do_launches = 0
dt_launches = 0


# --------------------------------------------------------------------------
# plain twins: the kernels' signatures, q-blocked so that no [N, P, P]
# tensor exists
# --------------------------------------------------------------------------

def _cdist(cos):
    return (0.5 - 0.5 * cos).clamp_min(0.0)


def _exp_term(cd, m):
    return torch.exp(2.0 - 2.0 * (cd / (m + EPS)))


def mrf_forward_stats_plain(o, t, block: int = 1024):
    """o, t [N, P, C] -> m, z [N, P] f32; p_star [N, P] int64 (per q);
    k [N, P] f32 and q_star [N, P] int64 (per p).  First index on ties."""
    n, p, _ = o.shape
    tf = t.float()
    m, z, p_star = [], [], []
    k = torch.full((n, p), -float("inf"), device=o.device)
    q_star = torch.zeros((n, p), dtype=torch.int64, device=o.device)
    for q0 in range(0, p, block):
        cd = _cdist(o[:, q0:q0 + block].float() @ tf.transpose(1, 2))
        mb, pb = cd.min(dim=2)
        be = _exp_term(cd, mb[..., None])
        zb = be.sum(dim=2)
        cmax, carg = (be / zb[..., None]).max(dim=1)
        upd = cmax > k             # strict: an earlier block keeps a tie
        k = torch.where(upd, cmax, k)
        q_star = torch.where(upd, carg + q0, q_star)
        m.append(mb)
        z.append(zb)
        p_star.append(pb)
    return torch.cat(m, 1), torch.cat(z, 1), torch.cat(p_star, 1), k, q_star


def _dcos(cos, m, z, dz, hit, dk):
    """The dense cotangent of cos and its by-product 2 be B cd, on a block
    whose m, z, dz broadcast against cos."""
    cd = _cdist(cos)
    be = _exp_term(cd, m)
    beb = be * (torch.where(hit, dk / z, torch.zeros_like(cos)) + dz)
    dcos = torch.where(cos < 1.0, beb / (m + EPS), torch.zeros_like(cos))
    return dcos, 2.0 * beb * cd


def mrf_bwd_do_plain(o, t, m, z, dz, q_star, dk, block: int = 1024):
    """-> do [N, P, C] in o's dtype, dm [N, P] f32.  m, z, dz: [N, P] per
    q; q_star: [N, P] per p; dk: [N]."""
    n, p, _ = o.shape
    tf = t.float()
    dk = dk[:, None, None]
    do, dm = [], []
    for q0 in range(0, p, block):
        q1 = min(q0 + block, p)
        cos = o[:, q0:q1].float() @ tf.transpose(1, 2)
        rows = torch.arange(q0, q1, device=o.device)[None, :, None]
        mb = m[:, q0:q1, None]
        dcos, by = _dcos(cos, mb, z[:, q0:q1, None], dz[:, q0:q1, None],
                         q_star[:, None, :] == rows, dk)
        dm.append(by.sum(dim=2) / (mb[..., 0] + EPS) ** 2)
        do.append((dcos @ tf).to(o.dtype))
    return torch.cat(do, 1), torch.cat(dm, 1)


def mrf_bwd_dt_plain(o, t, m, z, dz, q_star, dk, block: int = 1024):
    """-> dt [N, P, C] in t's dtype; arguments as mrf_bwd_do_plain."""
    n, p, _ = o.shape
    of = o.float()
    cols = torch.arange(p, device=o.device)[None, None, :]
    dk = dk[:, None, None]
    dt = []
    for p0 in range(0, p, block):
        cos_t = t[:, p0:p0 + block].float() @ of.transpose(1, 2)
        dcos_t, _ = _dcos(cos_t, m[:, None, :], z[:, None, :], dz[:, None, :],
                          q_star[:, p0:p0 + block, None] == cols, dk)
        dt.append((dcos_t @ of).to(t.dtype))
    return torch.cat(dt, 1)


# --------------------------------------------------------------------------
# the kernels' wrappers
# --------------------------------------------------------------------------

def _check(name, o, t, stats=()):
    _build.check_cuda_inputs(name, o, t)
    if o.dim() != 3 or o.shape != t.shape or o.shape[2] not in CHANNELS:
        raise ValueError(f"{name}: takes o, t [N, P, C] of one shape with C "
                         f"in {CHANNELS}, got {tuple(o.shape)} and "
                         f"{tuple(t.shape)}")
    for s, dtype in stats:
        if (s.device != o.device or s.dtype != dtype
                or not s.is_contiguous()):
            raise ValueError(f"{name}: statistics must be contiguous {dtype} "
                             f"on {o.device}, got {s.dtype} on {s.device}")


def mrf_forward_stats(o, t):
    """The forward kernel (CUDA) or its twin (CPU); see the twin."""
    global fwd_launches
    if o.device.type == "cpu":
        return mrf_forward_stats_plain(o, t)
    _check("mrf_forward_stats", o, t)
    o, t = _build.aligned16(o, t)
    n, p, c = o.shape
    f32 = dict(device=o.device, dtype=torch.float32)
    m, z = torch.empty((n, p), **f32), torch.empty((n, p), **f32)
    p_star = torch.empty((n, p), device=o.device, dtype=torch.int64)
    # (bits(K) << 32) | (0xFFFFFFFF - q*) per column; K >= 0, so the packed
    # value is a non-negative int64 and the atomic max orders it right
    packed = torch.zeros((n, p), device=o.device, dtype=torch.int64)
    with torch.cuda.device(o.device):
        rc = _build.library().cfen_mrf_fwd(
            o.data_ptr(), t.data_ptr(), m.data_ptr(), z.data_ptr(),
            p_star.data_ptr(), packed.data_ptr(), n, p, c,
            _build.dtype_code(o), _build.stream(o))
    _build.check(rc, "cfen_mrf_fwd")
    fwd_launches += 1
    k = (packed >> 32).to(torch.int32).view(torch.float32)
    q_star = 0xFFFFFFFF - (packed & 0xFFFFFFFF)
    return m, z, p_star, k, q_star


def _bwd_stats(m, z, dz, q_star, dk):
    f32 = torch.float32
    return ((m, f32), (z, f32), (dz, f32), (q_star, torch.int64), (dk, f32))


def mrf_bwd_do(o, t, m, z, dz, q_star, dk):
    """The do kernel (CUDA) or its twin (CPU); see the twin."""
    global do_launches
    if o.device.type == "cpu":
        return mrf_bwd_do_plain(o, t, m, z, dz, q_star, dk)
    _check("mrf_bwd_do", o, t, _bwd_stats(m, z, dz, q_star, dk))
    o, t = _build.aligned16(o, t)
    n, p, c = o.shape
    do = torch.empty_like(o)
    dm = torch.empty((n, p), device=o.device, dtype=torch.float32)
    with torch.cuda.device(o.device):
        rc = _build.library().cfen_mrf_bwd_do(
            o.data_ptr(), t.data_ptr(), m.data_ptr(), z.data_ptr(),
            dz.data_ptr(), q_star.data_ptr(), dk.data_ptr(), do.data_ptr(),
            dm.data_ptr(), n, p, c, _build.dtype_code(o), _build.stream(o))
    _build.check(rc, "cfen_mrf_bwd_do")
    do_launches += 1
    return do, dm


def mrf_bwd_dt(o, t, m, z, dz, q_star, dk):
    """The dt kernel (CUDA) or its twin (CPU); see the twin."""
    global dt_launches
    if o.device.type == "cpu":
        return mrf_bwd_dt_plain(o, t, m, z, dz, q_star, dk)
    _check("mrf_bwd_dt", o, t, _bwd_stats(m, z, dz, q_star, dk))
    o, t = _build.aligned16(o, t)
    n, p, c = o.shape
    dt = torch.empty_like(t)
    with torch.cuda.device(o.device):
        rc = _build.library().cfen_mrf_bwd_dt(
            o.data_ptr(), t.data_ptr(), m.data_ptr(), z.data_ptr(),
            dz.data_ptr(), q_star.data_ptr(), dk.data_ptr(), dt.data_ptr(),
            n, p, c, _build.dtype_code(o), _build.stream(o))
    _build.check(rc, "cfen_mrf_bwd_dt")
    dt_launches += 1
    return dt


# --------------------------------------------------------------------------
# the loss core
# --------------------------------------------------------------------------

class MrfCore(torch.autograd.Function):
    """sum_n -log(mean_p K) with the hand-derived backward of the JAX
    `_mrf_core_bwd` (pallas_mrf.py):

      dK = -g / (div P)
      dz[q] = -(dK / z[q]) sum_{p: q*[p] = q} K[p]    (index_add_)
      do, dm, dt from the two backward kernels
      rank-1 argmin terms: dcos[q, p*[q]] += -dm[q] / 2, dropped where the
      row min came from the clamp (m == 0), added in float32 and cast back.
    """

    @staticmethod
    def forward(ctx, o_n, t_n):
        m, z, p_star, k, q_star = mrf_forward_stats(o_n, t_n)
        div = k.mean(dim=1)
        ctx.save_for_backward(o_n, t_n, m, z, p_star, k, q_star, div)
        return (-torch.log(div)).sum()

    @staticmethod
    def backward(ctx, g):
        o_n, t_n, m, z, p_star, k, q_star, div = ctx.saved_tensors
        n, p, c = o_n.shape
        dk = (-g / (div * p)).float().contiguous()                   # [N]
        offs = torch.arange(n, device=o_n.device)[:, None] * p
        sum_kq = torch.zeros(n * p, device=o_n.device).index_add_(
            0, (q_star + offs).reshape(-1), k.reshape(-1)).view(n, p)
        dz = (-dk[:, None] * sum_kq / z).contiguous()
        do, dm = mrf_bwd_do(o_n, t_n, m, z, dz, q_star, dk)
        dt = mrf_bwd_dt(o_n, t_n, m, z, dz, q_star, dk)
        coef = torch.where(m > 0, -0.5 * dm, torch.zeros_like(dm))[..., None]
        t_at = torch.gather(t_n.float(), 1, p_star[..., None].expand(n, p, c))
        do = do.float() + coef * t_at
        dt_sc = torch.zeros((n * p, c), device=o_n.device).index_add_(
            0, (p_star + offs).reshape(-1), (coef * o_n.float()).reshape(-1, c))
        dt = dt.float() + dt_sc.view(n, p, c)
        return do.to(o_n.dtype), dt.to(t_n.dtype)


def _mrf_rows(o_rows, t_n):
    """cs rows of a q-block, [N, b, C] x [N, P, C] -> [N, b, P] (JAX
    losses/vgg.py _mrf_rows)."""
    cos = o_rows.float() @ t_n.float().transpose(1, 2)
    cdist = (-(cos - 1.0) / 2.0).clamp_min(0.0)
    rel = cdist / (cdist.amin(dim=2, keepdim=True) + EPS)
    before = torch.exp((1.0 - rel) / 0.5)
    return before / before.sum(dim=2, keepdim=True)


def _block_colmax(o_rows, t_n):
    return _mrf_rows(o_rows, t_n).amax(dim=1)


def mrf_core_plain(o_n, t_n, block: int = 2048):
    """The dense form (JAX losses/vgg.py _mrf): q-blocks with a running
    column max, each block recomputed in the backward
    (torch.utils.checkpoint), so at most one [N, block, P] slab lives."""
    kmax = None
    for q0 in range(0, o_n.shape[1], block):
        bmax = checkpoint(_block_colmax, o_n[:, q0:q0 + block], t_n,
                          use_reentrant=False)
        kmax = bmax if kmax is None else torch.maximum(kmax, bmax)
    return (-torch.log(kmax.mean(dim=1))).sum()


def mrf_core(o_n, t_n):
    """sum_n -log(mean_p max_q cs[q, p]) for normalised [N, P, C]."""
    if o_n.device.type == "cpu":
        return mrf_core_plain(o_n, t_n)
    return MrfCore.apply(o_n.contiguous(), t_n.contiguous())
