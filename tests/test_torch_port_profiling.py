"""The port's profiling and --verbose (cfen_vit_tpu_torch/utils/
profiling.py, utils/netinfo.py, train/cli.py) against the JAX package's
(cfen_vit_tpu/utils/profiling.py, utils/netinfo.py, train.py:58-65):
--trace_dir traces steps 10 to 15, a traced step writes a readable trace,
and --verbose prints the JAX package's totals for the same networks."""

import contextlib
import io
import json
from unittest import mock

import numpy as np
import pytest
import torch

import jax

from cfen_vit_tpu.models import discriminator as JD
from cfen_vit_tpu.utils import netinfo as JN
from cfen_vit_tpu_torch.config import parse_args
from cfen_vit_tpu_torch.interop.from_jax import (
    discriminator_state_dict_from_jax, state_dict_from_jax)
from cfen_vit_tpu_torch.models.discriminator import Discriminator
from cfen_vit_tpu_torch.models.generator import Generator
from cfen_vit_tpu_torch.utils import netinfo as TN
from cfen_vit_tpu_torch.utils import profiling as TP
from tests import torch_variant_cases as C
from tests.torch_variant_cases import one_torch_thread  # noqa: F401


class _StubTrainer:
    """The trainer's interface, counting steps."""

    def __init__(self):
        self.steps = 0
        self.g, self.d = torch.nn.Linear(2, 2), {}

    def setup(self, cfg):
        pass

    def set_input(self, data):
        pass

    def optimize_parameters(self, cfg=None):
        self.steps += 1

    def get_current_losses(self):
        return {"G": 1.0}

    def get_current_visuals(self):
        return {}

    def save_networks(self, epoch):
        pass

    def update_learning_rate(self):
        pass


class _Loader(list):
    """20 empty batches."""

    def __init__(self):
        super().__init__([{}] * 20)

    def load_data(self):
        return self


def test_trace_dir_traces_steps_10_to_15(tmp_path):
    from cfen_vit_tpu_torch.train import cli
    stub = _StubTrainer()
    calls = []
    with mock.patch("cfen_vit_tpu_torch.data.create_dataloader",
                    lambda cfg, mesh=None: _Loader()), \
            mock.patch("cfen_vit_tpu_torch.models.dehazing_model.create_model",
                       lambda cfg, device: stub), \
            mock.patch.object(TP, "start_trace",
                              lambda d: calls.append(("start", stub.steps, d))), \
            mock.patch.object(TP, "stop_trace",
                              lambda: calls.append(("stop", stub.steps)) or {}), \
            mock.patch.object(TP, "tracing", lambda: calls[-1][0] == "start"
                              if calls else False):
        log = cli.main(["--name", "t", "--checkpoints_dir", str(tmp_path),
                        "--gpu_ids", "-1", "--batchSize", "2", "--niter", "1",
                        "--niter_decay", "0", "--trace_dir",
                        str(tmp_path / "trace"), "--display_freq", "1000",
                        "--print_freq", "2"])
    # started before step 10 ran, stopped after step 15, once
    assert calls == [("start", 9, str(tmp_path / "trace")), ("stop", 15)]
    assert stub.steps == 20 and len(log["losses"]) == 20


def test_a_traced_step_writes_a_readable_trace(tmp_path):
    from cfen_vit_tpu_torch.parallel.mesh import tiny_batch, tiny_trainer
    tr = tiny_trainer(2, "", str(tmp_path))
    tr.set_input(tiny_batch(2))
    with TP.trace(str(tmp_path / "trace")):
        with TP.annotate("train step 1"):
            tr.optimize_parameters()
    assert not TP.tracing()
    with open(tmp_path / "trace" / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "train step 1" in names and "aten::convolution" in names
    summary = json.loads((tmp_path / "trace" / "summary.json").read_text())
    assert summary["steps"] == ["train step 1"] and summary["wall_ms"] > 0
    # no card here: no kernel time, and the split says so
    assert summary["kernel_ms"] == 0 and summary["busy_share"] == 0
    # the card idle throughout, by the innermost span of the tracing thread
    assert summary["idle_ms_by_span"]["train step 1"] > 0
    assert "Self CPU" in (tmp_path / "trace" / "key_averages.txt").read_text()


def test_kernel_groups_name_the_kernels():
    assert TP.group_of("void mrf_fwd_kernel<float>(...)") == "K5 mrf forward"
    assert TP.group_of("mrf_bwd_kernel<__nv_bfloat16, true>") == "K5 mrf do"
    assert TP.group_of("attn_kernel<float, 32, false>") == "K1 attention"
    assert TP.group_of("attn_wide_kernel<float, true>") == "K1 attention"
    assert TP.group_of("void tail_mma_kernel<1>(...)") == "K3 tail"
    assert TP.group_of("void tail_ffma_kernel<3>(...)") == "K3 tail"
    assert TP.group_of("void stem_kernel<float>(...)") == "K4 stem"
    assert TP.group_of("sm90_xmma_fprop_implicit_gemm") == "convolution (cuDNN)"


def _printed(fn, nets):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(nets, verbose=True)
    return out.getvalue().splitlines()


@pytest.mark.parametrize("name", [C.V3, "ipt"])
def test_verbose_totals_equal_jax(name):
    spec, tspec, tree = C.filled_tree(name)
    g = Generator(tspec)
    g.load_state_dict(state_dict_from_jax(tree, tspec), strict=True)
    cfg = parse_args(["--gpu_ids", "-1"], save_opt=False)
    dtree = jax.tree_util.tree_map(
        np.asarray, JD.nlayer_disc_init(jax.random.PRNGKey(3), 6, cfg.ndf, 3))
    d = Discriminator(cfg)
    d.load_state_dict(discriminator_state_dict_from_jax(dtree), strict=True)
    assert TN.count_params(g) == JN.count_params(tree)
    assert TN.count_params(d) == JN.count_params(dtree)
    port = _printed(TN.print_networks, {"G": g, "D_A": d})
    jax_lines = _printed(JN.print_networks, {"G": tree, "D_A": dtree})
    totals = [l for l in jax_lines if l.startswith("[Network")]
    assert [l for l in port if l.startswith("[Network")] == totals
    assert port[0] == jax_lines[0] and port[-1] == jax_lines[-1]
    # one structure line per module to depth 2, each with its count
    top = [l for l in port if l and not l.startswith((" ", "[", "-"))]
    assert {l.rstrip("/").split(":")[0] for l in top} == {
        n for n, _ in g.named_children()} | {n for n, _ in d.named_children()}
    counted = [l for l in port if l.startswith("  ") and "params" in l]
    assert len(counted) >= len(list(g.children()))
