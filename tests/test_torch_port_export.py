"""The port's reference `.pth` exporter (cfen_vit_tpu_torch/interop/
torch_export.py) against the JAX exporter (cfen_vit_tpu/interop/
torch_export.py): the export of from_jax(tree) equals the JAX export of
tree key for key and value for value, dead tensors included, and loads
back into the port strictly."""

import os
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cfen_vit_tpu_torch.interop.from_jax import state_dict_from_jax
from cfen_vit_tpu_torch.models import registry as TR
from cfen_vit_tpu_torch.models.generator import Generator
from cfen_vit_tpu_torch.train.checkpoint import load_net
from tests import torch_variant_cases as C
from tests.torch_variant_cases import release_file_memory  # noqa: F401

V3 = C.V3


@pytest.mark.parametrize("name", [V3, "iid_hlgvit_crs_gd4_cfs"])
def test_port_export_equals_jax_export(name, tmp_path):
    """The port's export of from_jax(tree) equals the JAX exporter's of
    tree, key for key and value for value, and loads back strictly."""
    from cfen_vit_tpu.interop.torch_export import export_generator_state_dict
    from cfen_vit_tpu_torch.interop import torch_export as TE
    spec, tspec, tree = C.filled_tree(name, seed=9)
    net = Generator(tspec)
    net.load_state_dict(state_dict_from_jax(tree, tspec), strict=True)
    got = TE.export_generator_state_dict(net)
    want = export_generator_state_dict(tree, spec)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        v = torch.tensor(np.asarray(v))
        if v.dtype == torch.float64:
            v = v.float()
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k
    path = TE.save_reference_pth(net, str(tmp_path / "5_net_G.pth"))
    back = Generator(tspec)
    load_net(SimpleNamespace(checkpoints_dir=str(tmp_path), name=""), "5",
             "G", back)
    got, want = back.state_dict(), net.state_dict()
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], v) for k, v in want.items())
    assert os.path.exists(path)


def test_export_refuses_what_the_jax_exporter_refuses():
    from cfen_vit_tpu_torch.interop.torch_export import export_generator_state_dict
    net = Generator(replace(TR.generator_spec("ipt"), **C.TINY))
    with pytest.raises(NotImplementedError, match="hlgvit"):
        export_generator_state_dict(net)
