"""The traffic generator: one seed gives one pool, two seeds two."""

import torch

from benchmark.loops import hazy
from benchmark.loops.infer_closed import sample
from benchmark.loops.train_closed import make_pool

CPU = torch.device("cpu")


def test_scenes_are_seeded():
    a = hazy.scenes(6, 64, 2 ** 33 + 1, CPU)
    b = hazy.scenes(6, 64, 2 ** 33 + 1, CPU)
    c = hazy.scenes(6, 64, 2 ** 33 + 2, CPU)
    for k in a:
        assert a[k].dtype == torch.uint8 and a[k].shape == (6, 64, 64, 3)
        assert torch.equal(a[k], b[k])
        assert not torch.equal(a[k], c[k])
    flat = a["hazy"].reshape(6, -1)
    assert all(not torch.equal(flat[i], flat[j])
               for i in range(6) for j in range(i))


def test_train_pool_in_the_loader_format():
    from cfen_vit_tpu_torch.train.trainer import _u8_wire
    pool = make_pool({"image_side": 32}, {"pool_batches": 3, "batch": 2}, 9, CPU)
    assert len(pool) == 3
    for batch in pool:
        assert batch["B"].shape == (2, 32, 32, 3) and batch["S"].shape == (2, 32, 32, 1)
        assert batch["B"].min() >= -1 and batch["B"].max() <= 1
        assert _u8_wire(batch["B"]).dtype.name == "uint8"


def test_sample_is_seeded_and_covers_the_pool():
    s = sample(5, 8, 16)
    assert s == sample(5, 8, 16) and s != sample(6, 8, 16)
    assert set(range(8)) <= s and len(s) == 24
