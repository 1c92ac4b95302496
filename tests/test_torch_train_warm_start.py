"""Warm starts (train/loop.py::warm_start) in the port against the JAX
package's ``warm_start`` on the same files, written here by the port's
exporter (utils/torch_export.py): a full Lightning ``.ckpt`` fills every
parameter and BatchNorm statistic, a DINOv2 backbone ``.pth`` the ViT only.
Both sides load the same float32 values, so the comparison is bitwise.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import SMALL, random_flax_variables

from picopose_tpu.models import PicoPose as JaxPicoPose
from picopose_tpu.train.loop import warm_start as jax_warm_start
from picopose_tpu.train.step import TrainState as JaxTrainState
from picopose_tpu_torch.models import PicoPose
from picopose_tpu_torch.train import loop, step
from picopose_tpu_torch.utils.torch_export import export_picopose, save_torch_checkpoint
from picopose_tpu_torch.utils.weights import load_flax_variables, state_dict_from_flax

VIT = "feature_extractor.dinov2."


@pytest.fixture(scope="module")
def trees():
    jmodel = JaxPicoPose(**SMALL, compute_dtype=jnp.float32)
    return random_flax_variables(jmodel, seed=1), random_flax_variables(jmodel, seed=2)


@pytest.fixture(scope="module")
def files(trees, tmp_path_factory):
    """The seed-2 weights as a full checkpoint and as backbone weights."""
    d = tmp_path_factory.mktemp("warm")
    model = PicoPose(**SMALL, compute_dtype=torch.float32, device="cpu")
    load_flax_variables(model, trees[1])
    save_torch_checkpoint(model, str(d / "full.ckpt"))
    backbone = {k[len(VIT):]: torch.from_numpy(v) for k, v in export_picopose(model).items() if k.startswith(VIT)}
    torch.save(backbone, d / "dinov2.pth")
    torch.save({k: v for k, v in backbone.items() if not k.startswith("blocks.3.")}, d / "dinov2_depth3.pth")
    bad = torch.load(d / "full.ckpt", weights_only=False)
    bad["state_dict"]["network.affine_regressor.fc2.weight"] = torch.zeros(256, 512)
    torch.save(bad, d / "bad_shape.ckpt")
    yield d
    shutil.rmtree(d, ignore_errors=True)  # ~0.55 GB


def _states(trees):
    """The JAX and the port's fresh states, both holding the seed-1 weights."""
    fresh = trees[0]
    jstate = JaxTrainState(jnp.zeros((), jnp.int32), fresh["params"], fresh["batch_stats"], None)
    tstate = step.init_state(step.make_optimizer(), device="cpu", **SMALL, compute_dtype=torch.float32)
    load_flax_variables(tstate.model, fresh)
    return jstate, tstate


@pytest.mark.parametrize("name", ["full.ckpt", "dinov2.pth"])
def test_warm_start_loads_as_jax_does(trees, files, name):
    jstate, tstate = _states(trees)
    path = str(files / name)
    jout = jax_warm_start(jstate, path)
    assert loop.warm_start(tstate, path) is tstate
    ref = state_dict_from_flax({"params": jout.params, "batch_stats": jout.batch_stats})
    got = tstate.model.state_dict()
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    fresh, loaded = (state_dict_from_flax(t) for t in trees)
    for k in ref:  # the backbone file fills the ViT only
        src = loaded if name == "full.ckpt" or k.startswith(VIT) else fresh
        np.testing.assert_array_equal(got[k].numpy(), src[k], err_msg=k)
    opt = tstate.optimizer
    assert tstate.step == 0 and opt.updates == int(opt.count) == 0 and tstate.model.training
    assert not any(bool(t.any()) for t in opt.tensors())


@pytest.mark.parametrize("name,match", [("dinov2_depth3.pth", "transformer blocks"),
                                        ("bad_shape.ckpt", "shape mismatch")])
def test_mismatched_checkpoints_raise_as_in_jax(trees, files, name, match):
    jstate, tstate = _states(trees)
    before = {k: v.clone() for k, v in tstate.model.state_dict().items()}
    with pytest.raises(ValueError, match=match):
        jax_warm_start(jstate, str(files / name))
    with pytest.raises(ValueError, match=match):
        loop.warm_start(tstate, str(files / name))
    assert all(torch.equal(before[k], v) for k, v in tstate.model.state_dict().items())


def test_directories_raise(trees, tmp_path):
    _, tstate = _states(trees)
    with pytest.raises(ValueError, match="directory"):
        loop.warm_start(tstate, str(tmp_path))
