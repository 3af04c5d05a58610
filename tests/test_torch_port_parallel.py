"""Data parallel in the port (cfen_vit_tpu_torch/parallel/mesh.py; JAX
cfen_vit_tpu/parallel/mesh.py and tests/test_parallel.py): one GAN step of
the tiny v3 trainer on 2 gloo ranks (`dryrun(2)`, two processes, each on
its contiguous half of the global batch) against the same step in one
process on the whole batch.

Bars: every loss within JAX's 5e-3 (tests/test_parallel.py:91-93); G's
and each D's mean-reduced grads, read as Adam's first moments after the
step (0.1 x the grad), within 1e-3 of their norm (measured 9.1e-5 for G,
4.1e-7 for D on this CPU: shard sums reassociate float32, and tensors
whose exact grad is zero hold only float noise); the parameter updates
within 5e-3 of their norm (2.4e-4 measured; Adam's first step is
lr x sign(grad), so a grad of float noise can flip a whole lr); the pools
hold the global fakes within 1e-5."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cfen_vit_tpu_torch.parallel import mesh as M
from tests.torch_variant_cases import release_file_memory  # noqa: F401

LOSS_TOL, MOMENT_TOL, UPDATE_TOL, POOL_TOL = 5e-3, 1e-3, 5e-3, 1e-5


def _rel(a, b):
    a = torch.cat([t.flatten().double() for t in a])
    b = torch.cat([t.flatten().double() for t in b])
    return float((a - b).norm() / a.norm())


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    out = M.dryrun(2, str(tmp / "rank0.pt"))
    assert "dryrun(2) ok" in out
    two = torch.load(tmp / "rank0.pt")
    tr = M.tiny_trainer(2, "", str(tmp))
    start = {"g": {k: v.clone() for k, v in tr.g.state_dict().items()},
             "d": {k: v.clone() for k, v in tr.d.state_dict().items()}}
    tr.set_input(M.tiny_batch(2))
    tr.optimize_parameters()
    return start, M.step_record(tr), two


def test_two_gloo_ranks_match_one_process_losses(steps):
    _, one, two = steps
    assert sorted(one["losses"]) == sorted(two["losses"])
    for k, v in one["losses"].items():
        assert abs(v - two["losses"][k]) < LOSS_TOL * max(1.0, abs(v)), k


def test_two_gloo_ranks_match_one_process_grads_and_weights(steps):
    start, one, two = steps
    assert _rel(one["g_m"], two["g_m"]) < MOMENT_TOL
    assert _rel(one["d_m"], two["d_m"]) < MOMENT_TOL
    for net in ("g", "d"):
        keys = [k for k, v in one[net].items() if v.is_floating_point()]
        moved = [one[net][k] - start[net][k] for k in keys]
        moved2 = [two[net][k] - start[net][k] for k in keys]
        assert _rel(moved, moved2) < UPDATE_TOL, net
        for k, v in one[net].items():
            if not v.is_floating_point():   # the ActNorm flags
                assert torch.equal(v, two[net][k]), k
    for k, buf in one["pools"].items():
        assert float((buf - two["pools"][k]).abs().max()) < POOL_TOL, k


def test_mesh_shape_raises_where_it_cannot_train(monkeypatch, tmp_path):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert M.make_mesh("", 3).size == 1 and M.make_mesh("1", 3).size == 1
    with pytest.raises(ValueError, match="asks for 2 devices"):
        M.make_mesh("2", 4)
    with pytest.raises(ValueError, match="asks for 2 devices"):
        M.tiny_trainer(2, "2", str(tmp_path))
    with pytest.raises(NotImplementedError, match="2-D mesh"):
        M.make_mesh("2,2", 4)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="does not divide over 2 ranks"):
        M.make_mesh("2", 3)
    assert M.make_mesh("", 4).size == 2


def test_loader_gives_each_rank_its_contiguous_shard(monkeypatch):
    from cfen_vit_tpu_torch.data import loader as L
    monkeypatch.setattr(L, "create_dataset",
                        lambda cfg: [{"i": np.full((1,), i, np.float32)}
                                     for i in range(12)])
    cfg = SimpleNamespace(batchSize=4, nThreads=1, max_dataset_size=1e9,
                          sb=False, seed=3, isTrain=True)

    def epoch(mesh):
        dl = L.DataLoader(cfg, mesh)
        return [b["i"][:, 0].astype(int).tolist() for b in dl]
    ranks = [epoch(M.Mesh(r, 2)) for r in range(2)]
    assert all(len(b) == 2 for r in ranks for b in r)
    order = [x for b0, b1 in zip(*ranks) for x in b0 + b1]
    assert sorted(order) == list(range(12)) and order != list(range(12))
    assert epoch(M.Mesh(0, 2)) == ranks[0]      # the same order every run
    assert len(list(L.DataLoader(cfg, None))) == 3
