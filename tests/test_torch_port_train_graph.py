"""The trainer's captured step (cfen_vit_tpu_torch/train/trainer.py
GanTrainer._capture): a step on a card replays one CUDA graph of the
G and D losses and backward once the first step has run.

On the CPU:
  * the engagement predicate holds only on a card, with one micro-batch,
    one process, after the first step and for the captured signature;
  * `vgg19_features`' cached ImageNet mean gives the features the mean
    made on each call gave;
  * a step leaves no autograd graph alive (one that outlives its step
    makes the next capture fail);
  * the benchmark's `graph_steps.train` reads the replay counter.
A CPU trainer step against the JAX GanTrainer is
tests/test_torch_port_train.py's.

On the card (`cuda`): the v3 spec at full width, batch 2, 256x256, remat
branch, four steps through `optimize_parameters` with the graph (the
first eager, the second captured), then a batch of another shape, which
runs eagerly, each against an eager step from the same state.
"""

import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.run import reader
from cfen_vit_tpu_torch.losses import vgg as V
from cfen_vit_tpu_torch.utils import profiling as P


# --------------------------------------------------------------------------
# the CPU: predicate, ImageNet mean, reader
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stepped(tmp_path_factory):
    """A tiny CPU trainer after its first step, and a fresh one."""
    from cfen_vit_tpu_torch.parallel.mesh import tiny_batch, tiny_trainer
    from cfen_vit_tpu_torch.train.trainer import host_wire, signature
    tmp = str(tmp_path_factory.mktemp("graph"))
    tr = tiny_trainer(2, "", tmp)
    batch = tiny_batch(2)
    tr.set_input(batch)
    tr.optimize_parameters()
    return tr, tiny_trainer(2, "", tmp), signature(host_wire(batch))


@pytest.mark.parametrize("case", ["all hold", "cpu", "grad_accum 2",
                                  "launched mesh", "first step",
                                  "another signature"])
def test_graph_engages_only_where_it_can(stepped, monkeypatch, case):
    """Each condition of the predicate alone turns it off; with all of
    them it holds (the device made to read as a card: nothing runs)."""
    tr, fresh, sig = stepped
    if case == "first step":
        tr = fresh
    if case != "cpu":
        monkeypatch.setattr(tr, "device", torch.device("cuda", 0))
    if case == "grad_accum 2":
        monkeypatch.setattr(tr, "accum", 2)
    if case == "launched mesh":
        monkeypatch.setattr(tr, "mesh", types.SimpleNamespace(
            launched=True, size=2))
    if case == "another signature":
        monkeypatch.setattr(tr, "_graph", types.SimpleNamespace(signature=sig))
        sig = tuple((k, (1,) + shape[1:], dt) for k, shape, dt in sig)
    assert tr._graph_engages(sig) is (case == "all hold")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vgg_mean_is_made_once_and_exact(dtype):
    """subtract_mean=True gives bit for bit the features of the input less
    the mean made from the list on the call, and the mean is one tensor
    for every call on a device and dtype."""
    vgg = V.vgg19_init().to(dtype)
    x = torch.randn(2, 3, 16, 16, generator=torch.Generator().manual_seed(3)
                    ).to(dtype)
    taps = ("relu3_1", "relu4_1")
    got = V.vgg19_features(vgg, x, taps, subtract_mean=True)
    mean = torch.tensor(V._IMAGENET_MEAN, dtype=dtype).view(1, 3, 1, 1)
    want = V.vgg19_features(vgg, x - mean, taps)
    for t in taps:
        assert torch.equal(got[t], want[t]), t
    assert V._imagenet_mean(dtype, x.device) is V._imagenet_mean(dtype,
                                                                 x.device)


@pytest.mark.parametrize("model_g", ["iid_cnn_crs", "iid_hlgvit_crs_gd4_cfs_v3"])
def test_a_step_leaves_no_autograd_graph_alive(tmp_path, model_g):
    """Two remat-branch steps leave no tensor with autograd history behind:
    a graph that outlives its step holds the parameters' gradient
    accumulators, and a capture that meets one made on the default stream
    fails (iid_cnn_crs's D level-2 output, which no loss reaches)."""
    import gc
    from cfen_vit_tpu_torch.config import parse_args
    from cfen_vit_tpu_torch.parallel.mesh import tiny_batch
    from cfen_vit_tpu_torch.train.trainer import GanTrainer

    def alive():
        gc.collect()
        return sum(1 for o in gc.get_objects()
                   if isinstance(o, torch.Tensor) and o.grad_fn is not None)
    argv = ["--name", "t", "--checkpoints_dir", str(tmp_path), "--gpu_ids",
            "-1", "--model_G", model_g, "--n_feats", "8", "--loadSize", "64",
            "--patch_size", "8", "--num_heads", "2", "--hidden_dim_ratio", "2",
            "--batchSize", "2", "--pool_size", "2", "--remat_mode", "branch"]
    tr = GanTrainer(parse_args(argv, save_opt=False), torch.device("cpu"))
    batch = tiny_batch(2)
    if not tr.spec.half_res_trunk:
        batch = {k: v[:, ::2, ::2] if isinstance(v, np.ndarray) else v
                 for k, v in batch.items()}
    before = alive()
    for _ in range(2):
        tr.set_input(batch)
        tr.optimize_parameters()
    assert alive() == before


def test_graph_steps_reader(monkeypatch):
    """graph_steps.train: replays over the window's steps; nothing where
    the program has no such counter (a parent without the graph)."""
    from benchmark.metrics import _spans as S
    read = reader("graph_steps.train")
    monkeypatch.setattr(S, "program", lambda: ([], {"graph_replays": 6,
                                                    "syncs": 6}))
    assert read({"count": 6}, None) == 1.0
    monkeypatch.setattr(S, "program", lambda: ([], {"syncs": 6}))
    assert read({"count": 6}, None) is None


# --------------------------------------------------------------------------
# the card
# --------------------------------------------------------------------------

SIDE = 256


def card_trainer(dtype: str, tmp: str):
    """The v3 spec at full width for SIDE x SIDE images, batch 2, remat
    branch, on cuda:0, weights from the default seed."""
    from cfen_vit_tpu_torch.config import parse_args, set_precision
    from cfen_vit_tpu_torch.train.trainer import GanTrainer
    argv = ["--name", "graph", "--checkpoints_dir", tmp, "--gpu_ids", "0",
            "--model", "dec_vit", "--model_G", "iid_hlgvit_crs_gd4_cfs_v3",
            "--n_feats", "24", "--hidden_dim_ratio", "4",
            "--patch_size", str(SIDE // 16), "--num_heads", "4",
            "--loadSize", str(SIDE // 2), "--batchSize", "2",
            "--remat_mode", "branch", "--compute_dtype", dtype]
    cfg = parse_args(argv, save_opt=False)
    set_precision(cfg.precision)
    return GanTrainer(cfg, torch.device("cuda", 0))


def card_batches(n: int, size: int = 2, seed: int = 11) -> list:
    """n loader batches of `size` SIDE x SIDE images on the uint8 grid."""
    r = np.random.RandomState(seed)
    return [{k: (r.randint(0, 256, (size, SIDE, SIDE, 1 if k == "S" else 3))
                 .astype(np.float32) / 127.5 - 1.0) for k in "BARS"}
            for _ in range(n)]


def copy_state(dst, src) -> None:
    """dst's G, Ds, Adam state and step count set to src's (the pools are
    not: their answer is discarded)."""
    dst.g.load_state_dict(src.g.state_dict())
    dst.d.load_state_dict(src.d.state_dict())
    for od, os_ in ((dst.g_opt, src.g_opt), (dst.d_opt, src.d_opt)):
        od.state.clear()
        for pd, ps in zip(*(
                [p for g in o.param_groups for p in g["params"]]
                for o in (od, os_))):
            if ps in os_.state:
                od.state[pd] = {k: v.clone() for k, v in os_.state[ps].items()}
    dst.step = src.step


def record_grads(monkeypatch, tr) -> dict:
    """The grads Adam reads at each step, by network, cloned as it runs."""
    got = {}
    for tag, opt in (("G", tr.g_opt), ("D", tr.d_opt)):
        def step(*args, _tag=tag, _opt=opt, _step=opt.step, **kw):
            got[_tag] = [p.grad.clone() for g in _opt.param_groups
                         for p in g["params"]]
            return _step(*args, **kw)
        monkeypatch.setattr(opt, "step", step)
    return got


def net_state(tr) -> dict:
    """Every leaf and Adam moment (once Adam has stepped), as a list a
    network."""
    out = {}
    for tag, net, opt in (("G", tr.g, tr.g_opt), ("D", tr.d, tr.d_opt)):
        ps = list(net.parameters())
        out[tag] = [p.detach().clone() for p in ps]
        for m in ("exp_avg", "exp_avg_sq"):
            if ps[0] in opt.state:
                out[f"{tag}.{m}"] = [opt.state[p][m].clone() for p in ps]
    return out


def l2_gap(a: list, b: list) -> float:
    """|a - b| over |b|, each the L2 norm over the list's tensors."""
    num = sum(float((x.double() - y.double()).square().sum())
              for x, y in zip(a, b))
    den = sum(float(y.double().square().sum()) for y in b)
    return (num / max(den, 1e-300)) ** 0.5


def exact(a: dict, b: dict) -> list:
    """The names of the items of a and b that differ in any bit."""
    return [k for k in b if not torch.equal(a[k], b[k])]


def one_step(tr, batch):
    tr.set_input(batch)
    tr.optimize_parameters()
    out = {f"loss.{k}": v.detach().clone() for k, v in tr._losses.items()}
    out.update({f"fake.{k}": v.detach().clone() for k, v in tr._fakes.items()})
    return out


# Bars on the L2 gap, over a network, of its grads, its Adam moments and
# its leaves' change in one step, between two steps from one state on one
# batch: 5 to 9 times the largest that two eager steps read on the card (float32
# 1.5e-7, 1.5e-7, 5.9e-5; bfloat16 1.8e-3, 1.2e-3, 2.4e-2; PERF.md section 6).
# The Ds read 0.
GAP = {"float32": {"grad": 1e-6, "moment": 1e-6, "change": 5e-4},
       "bfloat16": {"grad": 1e-2, "moment": 1e-2, "change": 0.2}}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graph_step_matches_the_eager_step(tmp_path, monkeypatch, dtype):
    """Four steps with the graph (the first eager, the second captured and
    replayed, then two replays), then a batch of another shape (eager),
    each against an eager step from the same state on the same batch.
    On cuDNN's deterministic algorithms the losses and fakes agree bit for
    bit; G's grads, moments and change within GAP, not bit for bit: its
    backward adds with atomics in ATen's kernels (bilinear upsampling's
    among them), so two eager steps from one state differ there too."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    batches = card_batches(4) + card_batches(1, size=1, seed=12)
    graphed = card_trainer(dtype, str(tmp_path))
    eager = card_trainer(dtype, str(tmp_path))
    monkeypatch.setattr(eager, "_graph_engages", lambda sig: False)
    got_grads = record_grads(monkeypatch, graphed)
    want_grads = record_grads(monkeypatch, eager)
    with profile(activities=[ProfilerActivity.CPU]):
        for i, batch in enumerate(batches):
            if i:
                copy_state(eager, graphed)
            start = {net: [p.detach().clone() for p in getattr(graphed, net.lower())
                           .parameters()] for net in ("G", "D")}
            got, want = one_step(graphed, batch), one_step(eager, batch)
            assert exact(got, want) == [], i
            after, ref = net_state(graphed), net_state(eager)
            bar = GAP[dtype]
            for net in ("G", "D"):
                assert l2_gap(got_grads[net], want_grads[net]) < bar["grad"]
                change = [a - s for a, s in zip(after[net], start[net])]
                ref_change = [a - s for a, s in zip(ref[net], start[net])]
                assert l2_gap(change, ref_change) < bar["change"], (i, net)
                for m in ("exp_avg", "exp_avg_sq"):
                    assert l2_gap(after[f"{net}.{m}"], ref[f"{net}.{m}"]
                                  ) < bar["moment"], (i, net, m)
        counters = P.counters()
    assert graphed._graph is not None
    assert counters.get("graph_captures") == 1
    assert counters.get("graph_replays") == 3
