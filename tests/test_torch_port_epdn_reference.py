"""The port's EPDN (models/epdn.py, train/pix2pixhd.py EpdnTrainer) against
the benchmark's plain reference (benchmark/reference/epdn.py) on the CPU,
on weights drawn from a seed, and EPDN on the train CLI.

The networks and the step run in float64 at 64x64: the global trunk's
instance norms then see 2x2 maps, where float32 grads are noise (in
tests/test_torch_port_epdn.py the JAX package's own float32 G grads came
out 1.07e-2 off its float64 step).  What is left between the two sides
in float64 is the order of the sums and the instance norm's variance
(one pass in the port, two in the reference): 1e-13 relative in the
losses and the grads, and each bar below lies more than ten times above
what the two sides read.  The pool runs in float64 on both sides, so
the pooled pair D trains on is not rounded.
"""

import ast
import gc
from collections import Counter
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import check
from benchmark.loops import epdn_closed as L
from benchmark.reference import epdn as E
from benchmark.reference.losses import VGG19
from benchmark.reference.weights import build, draw
from benchmark.run import reader
from cfen_vit_tpu_torch.config import Config
from cfen_vit_tpu_torch.models import epdn as TE
from cfen_vit_tpu_torch.models.dehazing_model import create_model
from cfen_vit_tpu_torch.utils import profiling as P

CPU = torch.device("cpu")
SEED = 2 ** 33 + 5
# the reference's keys at tiny widths; the trainer builds pix2pixHD's 4
# downsamplings, 9 global and 3 local blocks
TINY = dict(ngf=4, ngf_global=8, n_downsample_global=4, n_blocks_global=9,
            n_blocks_local=3, dehaze_blocks=2, dehaze_channels=20, num_D=2,
            n_layers_D=3, ndf=8, lambda_feat=10.0, gan_mode="lsgan",
            pool_size=2)
LR, BETA1 = 2e-4, 0.5
# float64 (module docstring): losses and outputs relative (read: 1.3e-13);
# grads as the relative norm of each network's difference (5e-13) and each
# tensor's difference over its norm (6e-13) plus 1e-12 (a bias before an
# instance norm gets a grad of pure round-off, 1e-17 to 1e-14; read 4e-14);
# parameters absolute: lr times Adam's normalised step (read 9e-12), and
# where the grad is round-off, which Adam's eps of 1e-8 turns into steps
# of lr |g| / 1e-8, a looser bar (read 7e-10); the port's visuals come
# back as float32 (6e-8 relative rounding an element)
LOSS_BAR, OUT_BAR, NET_GRAD_BAR, TENSOR_GRAD_BAR, VISUAL_BAR = (
    1e-9, 1e-9, 1e-9, 1e-7, 1e-6)
PARAM_BAR, ROUND_OFF_PARAM_BAR = 1e-10, 1e-8


def _drawn(module_fn, name):
    with torch.device("meta"):
        meta = module_fn()
    return {k: v.double() for k, v in draw(meta, SEED, name, CPU).items()}


def _x(channels, seed, side=64):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((2, channels, side, side), generator=g,
                      dtype=torch.float64) * 2 - 1


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def test_local_enhancer_matches_reference():
    """pix2pixHD's output and the enhanced one, from one state dict."""
    state = _drawn(lambda: E.LocalEnhancer(TINY), "G")
    ref = build(lambda: E.LocalEnhancer(TINY), state, CPU).double()
    port = TE.LocalEnhancer(3, 3, TINY["ngf"]).double()
    port.load_state_dict(state, strict=True)
    x = _x(3, 1)
    with torch.no_grad():
        for got, want in zip(port(x), ref(x)):
            assert _rel(got, want) < OUT_BAR


def test_multiscale_discriminator_features_match_reference():
    """Every block's output of both scales (5 a scale at n_layers_D 3)."""
    state = _drawn(lambda: E.MultiscaleDiscriminator(TINY), "D")
    ref = build(lambda: E.MultiscaleDiscriminator(TINY), state, CPU).double()
    port = TE.MultiscaleDiscriminator(6, TINY["ndf"], TINY["n_layers_D"],
                                      TINY["num_D"]).double()
    port.load_state_dict(state, strict=True)
    x = _x(6, 2)
    with torch.no_grad():
        got, want = port(x, get_interm_feat=True), ref(x)
    assert [len(s) for s in got] == [len(s) for s in want] == [5, 5]
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            assert g.shape == w.shape and _rel(g, w) < OUT_BAR


def _config(tmp_path, **kw):
    cfg = Config(model="epdn", name="ep", checkpoints_dir=str(tmp_path),
                 epdn_ngf=TINY["ngf"], ndf=TINY["ndf"], num_D=TINY["num_D"],
                 n_layers_D=TINY["n_layers_D"], pool_size=TINY["pool_size"],
                 batchSize=2, lr=LR, beta1=BETA1, gpu_ids="-1", **kw)
    cfg.isTrain = True
    return cfg


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """Two steps of the port's EpdnTrainer and of the reference from the
    same weights and pool generator state, at batch 2 = pool_size: the
    first fills the pool, the second draws from it."""
    port = create_model(_config(tmp_path_factory.mktemp("epdn")), CPU)
    state = {"G": _drawn(lambda: E.LocalEnhancer(TINY), "G"),
             "D": _drawn(lambda: E.MultiscaleDiscriminator(TINY), "D"),
             "VGG": _drawn(VGG19, "VGG19")}
    for net in (port.g, port.d, port.vgg):
        net.double()
    port.load_state_dicts(g=state["G"], d=state["D"], vgg=state["VGG"])
    port.pool_dtype = torch.float64
    gen = torch.Generator()
    gen.set_state(port.pool_gen.get_state())
    g, d, vgg = (build(f, state[k], CPU).double() for f, k in (
        (lambda: E.LocalEnhancer(TINY), "G"),
        (lambda: E.MultiscaleDiscriminator(TINY), "D"), (VGG19, "VGG")))
    ref = E.RefEpdn(TINY, g, d, vgg, E.Pool(TINY["pool_size"], gen), LR, BETA1)
    out = {"port": [], "ref": []}
    for i in range(2):
        batch = {k: _x(3, 10 + 2 * i + j).permute(0, 2, 3, 1).numpy()
                 for j, k in enumerate("BA")}
        port.set_input(batch)
        port.optimize_parameters()
        want = ref.step({k: torch.from_numpy(v).permute(0, 3, 1, 2)
                         for k, v in batch.items()})
        for side, losses, leaves, opts, vis in (
                ("port", port.get_current_losses(), L.leaves(port),
                 (port.g_opt, port.d_opt), port.get_current_visuals()),
                ("ref", want, ref.leaves(), ref.optimizers(), ref.visuals())):
            moments = {}
            for opt in opts:
                moments.update(opt.state)
            out[side].append({
                "losses": losses, "visuals": L._fakes(vis),
                "params": {k: p.detach().clone() for k, p in leaves.items()},
                "grad": {k: moments[p]["exp_avg"] / (1 - BETA1)
                         for k, p in leaves.items()} if i == 0 else None})
    out["pools"] = (port.pool, ref.pool)
    return out


def test_step_losses_and_outputs_match_reference(steps):
    """The four G terms, the two D terms and G's sum, both steps; the
    enhanced and the pix2pixHD output."""
    for got, want in zip(steps["port"], steps["ref"]):
        assert set(got["losses"]) == set(want["losses"]) == {
            "G_GAN", "G_GAN_Feat", "G_VGG", "G_L2", "D_fake", "D_real", "G"}
        for k, v in want["losses"].items():
            assert abs(got["losses"][k] - v) <= LOSS_BAR * abs(v), k
        assert set(got["visuals"]) == set(want["visuals"]) == {
            "fake_A", "fake_A_synth"}
        for k, v in want["visuals"].items():
            assert np.linalg.norm(got["visuals"][k] - v) <= (
                VISUAL_BAR * np.linalg.norm(v)), k


def test_step_grads_match_reference(steps):
    got, want = steps["port"][0]["grad"], steps["ref"][0]["grad"]
    assert set(got) == set(want)
    for net in "GD":
        keys = [k for k in want if k.startswith(f"{net}.")]
        diff = sum(float((got[k] - want[k]).norm()) ** 2 for k in keys)
        ref = sum(float(want[k].norm()) ** 2 for k in keys)
        assert (diff / ref) ** 0.5 < NET_GRAD_BAR, net
        for k in keys:
            err = float((got[k] - want[k]).norm())
            assert err <= TENSOR_GRAD_BAR * float(want[k].norm()) + 1e-12, k


def test_step_params_and_pool_match_reference(steps):
    """The parameters after Adam, both steps; the pool's images after the
    second step's draws."""
    grad = steps["ref"][0]["grad"]
    reached = check._moved({k: float(v.norm()) for k, v in grad.items()})
    for got, want in zip(steps["port"], steps["ref"]):
        for k, v in want["params"].items():
            bar = PARAM_BAR if k in reached else ROUND_OFF_PARAM_BAR
            assert float((got["params"][k] - v).abs().max()) <= bar, k
    port_pool, ref_pool = steps["pools"]
    assert port_pool["n"] == len(ref_pool.images) == TINY["pool_size"]
    for i, img in enumerate(ref_pool.images):
        assert _rel(port_pool["buf"][i], img) < OUT_BAR


def _write_pairs(root, n=2, size=64):
    from PIL import Image
    rng = np.random.RandomState(3)
    for d in ("hazy", "clear", "r", "s"):
        (root / d).mkdir(parents=True)
        for i in range(n):
            Image.fromarray((rng.rand(size, size, 3) * 255).astype(
                np.uint8)).save(root / d / f"im_{i}.png")


def test_train_cli_trains_epdn(tmp_path, capsys):
    """`python -m cfen_vit_tpu_torch.train --model epdn`: two steps through
    create_model, the loader and the loop, the losses logged, the nets'
    structure printed, visuals and checkpoints written, and G's
    checkpoint loads back."""
    from cfen_vit_tpu_torch.train.cli import main
    _write_pairs(tmp_path / "data")
    log = main(["--dataroot", str(tmp_path / "data"), "--name", "ep",
                "--checkpoints_dir", str(tmp_path / "ckpt"), "--model", "epdn",
                "--epdn_ngf", "4", "--ndf", "8", "--pool_size", "2",
                "--batchSize", "1", "--sb", "--niter", "1", "--niter_decay",
                "0", "--lr_policy", "step", "--print_freq", "1",
                "--display_freq", "1", "--update_html_freq", "1", "--verbose",
                "--gpu_ids", "-1"])
    tr = log["model"]
    assert type(tr).__name__ == "EpdnTrainer" and tr.step == 2
    assert len(log["losses"]) == 2 and all(
        np.isfinite(v) for losses in log["losses"] for v in losses.values())
    printed = capsys.readouterr().out
    assert "[Network G]" in printed and "[Network D]" in printed
    ckpt = tmp_path / "ckpt" / "ep"
    for f in ("1_net_G.pth", "1_net_D.pth", "latest_net_G.pth",
              "1_train_state.pt", "loss_log.jsonl"):
        assert (ckpt / f).exists(), f
    images = {p.name for p in (ckpt / "web" / "images").iterdir()}
    assert any(n.endswith("fake_A_synth.png") for n in images)
    g = TE.LocalEnhancer(3, 3, 4)
    g.load_state_dict(torch.load(ckpt / "1_net_G.pth", weights_only=True))
    assert any(not torch.equal(a, b) for a, b in zip(
        g.state_dict().values(), TE.init_epdn(
            TE.LocalEnhancer(3, 3, 4),
            torch.Generator().manual_seed(1)).state_dict().values()))
    # --continue_train resumes the nets, Adam and the step count
    cfg = _config(tmp_path / "ckpt", continue_train=True, which_epoch="1")
    back = create_model(cfg, CPU)
    back.setup(cfg)
    assert back.step == tr.step == 2
    for a, b in ((back.g, tr.g), (back.d, tr.d)):
        for x, y in zip(a.state_dict().values(), b.state_dict().values()):
            assert torch.equal(x, y)
    assert back.g_opt.state_dict()["state"].keys() == tr.g_opt.state_dict()[
        "state"].keys()


def test_create_model_builds_epdn_only_for_training(tmp_path):
    cfg = _config(tmp_path)
    assert type(create_model(cfg, CPU)).__name__ == "EpdnTrainer"
    cfg.isTrain = False
    with pytest.raises(NotImplementedError, match="not implemented"):
        create_model(cfg, CPU)


def test_step_records_spans_and_d_passes(tmp_path):
    """The span tree of one step, four D passes and no read inside the
    step, read through the benchmark's readers."""
    tr = create_model(_config(tmp_path), CPU)
    batch = {k: _x(3, 20 + j).float().permute(0, 2, 3, 1).numpy()
             for j, k in enumerate("BA")}
    gc.disable()        # a collection would be a span inside the dehaze one
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            tr.set_input(batch)
            tr.optimize_parameters()
            counters = P.counters()
            losses = tr.get_current_losses()
    finally:
        gc.enable()
    recs = [r for r in P.spans() if r[0] != "gc"]
    names = [r[0] for r in recs]

    def children(parent):
        return [r[0] for r in recs if r[1] >= 0 and names[r[1]] == parent]
    assert [r[0] for r in recs if r[1] < 0] == [
        "train.set_input", "train.step", "sync.losses"]
    assert children("train.step") == [
        "train.g_loss", "train.g_backward", "train.pool", "train.d_step",
        "train.adam", "train.zero_grad"]
    assert children("train.g_loss") == [
        "train.g_forward", "train.d_on_fake", "train.feat_match", "train.vgg"]
    assert children("train.g_forward") == ["train.dehaze"]
    assert counters == {"d_passes": 4, "syncs": 0}
    assert all(r[2] == tr.batches == 1 for r in recs)

    # a made-up window over the step: the card busy but for the dehaze span,
    # which the dehaze reader reads on the host's clock alone
    step = recs[names.index("train.step")]
    dehaze = recs[names.index("train.dehaze")]
    t0, t1 = step[4], step[5]
    summary = {"window_s": (t1 - t0) / 1e9, "count": 1,
               "ops": [("k0", t0 / 1e3, (dehaze[4] - t0) / 1e3),
                       ("k1", dehaze[5] / 1e3, (t1 - dehaze[5]) / 1e3)]}
    assert reader("d_passes.train")(summary, None) == 4.0
    assert reader("syncs.train")(summary, None) == len(losses)   # the reads
    assert reader("dehaze_ms.train")(summary, None) == pytest.approx(
        (dehaze[5] - dehaze[4]) / 1e6)              # host ms, its own clock


@pytest.mark.parametrize("grid", ["u8", "float"])
def test_epdn_set_input_takes_the_wire(tmp_path, grid):
    """A loader batch (B, A, R, S) on the uint8 grid crosses as uint8, one
    off it as float32: A and B land on the device as float32 NCHW equal to
    the batch, R and S stay on the host, and each of A and B has one
    `.wire` and one `.copy` span inside `train.set_input`."""
    from cfen_vit_tpu_torch.train import pix2pixhd
    tr = create_model(_config(tmp_path), CPU)
    r = np.random.RandomState(4)
    shape = (2, 64, 64)
    if grid == "u8":
        batch = {k: r.randint(0, 256, shape + (1 if k == "S" else 3,))
                 .astype(np.float32) / 127.5 - 1.0 for k in "BARS"}
    else:
        batch = {k: r.rand(*shape, 1 if k == "S" else 3).astype(np.float32)
                 * 2 - 1 for k in "BARS"}
    wires, real_copy_in = [], pix2pixhd.copy_in

    def copy_in(wire, device, into=None):
        wires.append({k: v.dtype for k, v in wire.items()})
        return real_copy_in(wire, device, into)
    with mock.patch.object(pix2pixhd, "copy_in", copy_in), \
            profile(activities=[ProfilerActivity.CPU]):
        tr.set_input(batch)
    want = np.uint8 if grid == "u8" else np.float32
    assert wires == [{"A": want, "B": want}]
    assert sorted(tr._batch) == ["A", "B"]
    for k in "AB":
        got = tr._batch[k]
        assert got.dtype == torch.float32 and got.device == CPU
        assert torch.equal(got, torch.from_numpy(batch[k]).permute(0, 3, 1, 2))
    recs = P.spans()
    assert Counter(r[0] for r in recs if r[0] != "gc") == {
        "train.set_input": 1, "train.set_input.wire": 2,
        "train.set_input.copy": 2}
    assert all(recs[r[1]][0] == "train.set_input" for r in recs
               if r[0] in ("train.set_input.wire", "train.set_input.copy"))


@pytest.mark.parametrize("metric", ["dehaze_ms.train", "d_passes.train"])
def test_new_metrics_are_silent_on_a_program_without_them(metric, monkeypatch):
    """The dehazing trainer's spans and counters (as a program before the
    EPDN trainer records them): nothing to read."""
    from benchmark.metrics import _spans as S
    spans = [("train.step", -1, 1, 7, 0, 1000), ("train.g_loss", 0, 1, 7, 0,
                                                   900)]
    monkeypatch.setattr(S, "program", lambda: (spans, {"syncs": 1}))
    summary = {"window_s": 1e-6, "count": 1, "ops": [("k", 0.0, 0.5)]}
    assert reader(metric)(summary, None) is None


def _imported(module: str) -> set:
    """Every module `module` imports, at any depth of its code, and those
    that its imports from `benchmark` import in turn."""
    root = Path(__file__).resolve().parents[1]
    seen, todo = set(), [module]
    while todo:
        name = todo.pop()
        path = root / (name.replace(".", "/") + ".py")
        if name in seen or not path.exists():
            continue
        seen.add(name)
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                found = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                base = name.rsplit(".", node.level)[0] if node.level else ""
                mod = ".".join(p for p in (base, node.module or "") if p)
                found = [mod] + [f"{mod}.{a.name}" for a in node.names]
            else:
                continue
            todo += [m for m in found if m.startswith("benchmark.")]
            seen.update(found)
    return seen


@pytest.mark.parametrize("module", ["benchmark.reference.epdn",
                                    "benchmark.counts.epdn_flops"])
def test_reference_imports_neither_the_port_nor_jax(module):
    tops = {m.split(".")[0] for m in _imported(module)}
    assert "torch" in tops and not tops & {
        "jax", "jaxlib", "flax", "cfen_vit_tpu", "cfen_vit_tpu_torch"}
