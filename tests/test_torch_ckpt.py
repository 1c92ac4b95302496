"""Reference PyTorch checkpoints in and out of the port, against the JAX
package (utils/{torch_port,torch_export,checkpoint}.py).

Seeded flax variables of the small model and of ``dinov2_vits14`` go
through the JAX package's exporter into a Lightning ``.ckpt`` and a raw
``.pth``.  All comparisons are bitwise (the conversions only transpose,
flip, permute and rename):

  * the port's ``load_any`` then ``load_flax_variables`` gives the state
    ``load_flax_variables`` gives on the variables themselves;
  * the port's ``port_picopose`` tree equals the JAX ``port_picopose``
    tree leaf by leaf, and its ``port_dinov2`` the JAX one on a bare
    backbone checkpoint (strict mode's errors included);
  * the port's exporter equals the JAX ``export_picopose`` key for key,
    and a file it writes loads back into both packages;
  * ``PoseEstimator(checkpoint=)`` equals ``PoseEstimator(variables=)``;
    ``variables`` win over ``checkpoint``.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import SMALL, random_flax_variables

from picopose_tpu.models import PicoPose as JaxPicoPose
from picopose_tpu.utils import torch_port as jport
from picopose_tpu.utils.checkpoint import load_any as jax_load_any
from picopose_tpu.utils.torch_export import export_dinov2 as jax_export_dinov2
from picopose_tpu.utils.torch_export import export_picopose as jax_export_picopose
from picopose_tpu.utils.torch_export import save_torch_checkpoint as jax_save_torch_checkpoint
from picopose_tpu_torch.models import PicoPose
from picopose_tpu_torch.serve import PoseEstimator
from picopose_tpu_torch.utils import torch_port
from picopose_tpu_torch.utils.checkpoint import load_any
from picopose_tpu_torch.utils.torch_export import export_picopose, save_torch_checkpoint
from picopose_tpu_torch.utils.weights import load_flax_variables

CONFIGS = {
    "small": dict(SMALL, depth=4),
    "vits14": dict(vit_type="dinov2_vits14", blocks_to_take=(1, 3, 5, 7), depth=12),
}


@pytest.fixture(scope="module", params=list(CONFIGS))
def case(request, tmp_path_factory):
    cfg = dict(CONFIGS[request.param])
    depth = cfg.pop("depth")
    variables = random_flax_variables(JaxPicoPose(**cfg, compute_dtype=jnp.float32), seed=3)
    d = tmp_path_factory.mktemp(request.param)
    paths = {"ckpt": str(d / "model.ckpt"), "pth": str(d / "model.pth")}
    jax_save_torch_checkpoint(variables, paths["ckpt"], lightning=True)
    jax_save_torch_checkpoint(variables, paths["pth"], lightning=False)
    model = port_model(cfg, variables)
    yield cfg, depth, variables, paths, model
    shutil.rmtree(d, ignore_errors=True)  # ~0.7 GB for vits14


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The small model's case alone, for the tests that build several models."""
    cfg = dict(SMALL)
    variables = random_flax_variables(JaxPicoPose(**cfg, compute_dtype=jnp.float32), seed=3)
    d = tmp_path_factory.mktemp("small")
    path = str(d / "model.ckpt")
    jax_save_torch_checkpoint(variables, path)
    yield cfg, variables, path, port_model(cfg, variables)
    shutil.rmtree(d, ignore_errors=True)  # ~0.5 GB


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's, emptied when the test ends (an exported file is ~0.3 GB)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def port_model(cfg, variables):
    model = PicoPose(cfg["vit_type"], cfg["blocks_to_take"], torch.float32, device="cpu")
    load_flax_variables(model, variables)
    return model


def assert_states_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def assert_trees_equal(got, ref, path=""):
    if isinstance(ref, dict):
        assert set(got) == set(ref), (path, set(got) ^ set(ref))
        for k in ref:
            assert_trees_equal(got[k], ref[k], f"{path}/{k}")
    else:
        ref = np.asarray(ref)
        assert got.dtype == ref.dtype and np.array_equal(got, ref), path


@pytest.mark.parametrize("kind", ["ckpt", "pth"])
def test_load_any_builds_the_model_load_flax_variables_builds(case, kind):
    cfg, depth, _, paths, model = case
    got = port_model(cfg, load_any(paths[kind], depth=depth))
    assert_states_equal(got.state_dict(), model.state_dict())


@pytest.mark.parametrize("kind", ["ckpt", "pth"])
def test_port_picopose_equals_the_jax_port(case, kind):
    _, depth, _, paths, _ = case
    loaded = torch.load(paths[kind], map_location="cpu", weights_only=False)
    assert_trees_equal(torch_port.port_picopose(loaded, depth=depth), jport.port_picopose(loaded, depth=depth))


def test_port_dinov2_equals_the_jax_port(case):
    _, depth, variables, _, _ = case
    sd = jax_export_dinov2(variables["params"]["feature_extractor"])
    sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    sd["mask_token"] = torch.zeros(1, sd["cls_token"].shape[-1])  # benign leftover
    np_sd = torch_port.to_numpy_state_dict(sd)
    assert torch_port.dinov2_checkpoint_depth(sd) == jport.dinov2_checkpoint_depth(sd) == depth
    assert_trees_equal(torch_port.port_dinov2(np_sd, depth, strict=True), jport.port_dinov2(np_sd, depth, strict=True))
    with pytest.raises(ValueError, match="transformer blocks"):
        torch_port.port_dinov2(np_sd, depth + 1, strict=True)
    np_sd["register_tokens"] = np.zeros((1, 4, 8), np.float32)
    with pytest.raises(ValueError, match="cannot represent"):
        torch_port.port_dinov2(np_sd, depth, strict=True)


def test_export_equals_the_jax_exporter(case):
    _, _, variables, _, model = case
    got, ref = export_picopose(model), jax_export_picopose(variables)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape and np.array_equal(got[k], ref[k]), k


@pytest.mark.parametrize("lightning", [True, False])
def test_exported_files_load_into_both_packages(small, tmp_path, lightning):
    cfg, variables, _, model = small
    depth = 4
    path = str(tmp_path / ("model.ckpt" if lightning else "model.pth"))
    save_torch_checkpoint(model, path, lightning=lightning)
    loaded = torch.load(path, map_location="cpu", weights_only=True)
    assert ("state_dict" in loaded) == lightning
    assert_states_equal(port_model(cfg, load_any(path, depth=depth)).state_dict(), model.state_dict())
    assert_trees_equal(jax_load_any(path, depth=depth), jax.tree_util.tree_map(np.asarray, variables))


def test_pose_estimator_takes_a_checkpoint(small):
    cfg, variables, path, model = small
    kw = dict(vit_type=cfg["vit_type"], blocks_to_take=cfg["blocks_to_take"], device="cpu")
    # bf16: the weights are precast after loading, both ways
    ref = PoseEstimator(variables=variables, compute_dtype="bfloat16", **kw)
    got = PoseEstimator(checkpoint=path, compute_dtype="bfloat16", **kw)
    assert_states_equal(got.model.state_dict(), ref.model.state_dict())
    other = {"params": variables["params"], "batch_stats": jax.tree_util.tree_map(lambda a: a + 1.0,
                                                                                 variables["batch_stats"])}
    both = PoseEstimator(checkpoint=path, variables=other, compute_dtype="float32", **kw)
    assert_states_equal(both.model.state_dict(), port_model(cfg, other).state_dict())
    assert not torch.equal(both.model.state_dict()["flow_decoder.proj_bn.0.running_mean"],
                           model.state_dict()["flow_decoder.proj_bn.0.running_mean"])


def test_load_any_refuses_a_directory(tmp_path):
    """A directory that is not an orbax checkpoint raises with its path."""
    with pytest.raises(ValueError, match=f"{tmp_path}: not an orbax checkpoint"):
        load_any(str(tmp_path))
