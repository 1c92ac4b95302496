"""``python -m picopose_tpu_torch.export_torch`` against tools/export_torch.py,
and ``export_dinov2`` against the JAX package's.

* One torch ``.ckpt``, written by the JAX exporter from seeded
  vit_tiny_test variables: the port's CLI (as ``python -m`` runs it) and
  the JAX tool write the same keys and the same values, bitwise, with and
  without ``--raw``.  One difference of shape is pinned: each
  ``num_batches_tracked`` (0) is 0-d in the port's file, as torch's
  BatchNorm holds it, and (1,) in the JAX tool's (its
  ``np.ascontiguousarray`` lifts a 0-d array to 1-d); torch loads either.
* A train state the port saved (utils/checkpoint.py::save) exports to
  ``export_state_dict`` of its model; an orbax-like directory raises with
  ``read_weights``' message.
* ``export_dinov2`` of the port's ViT, its weights carried across from
  seeded flax variables by ``load_flax_variables``, gives the keys and
  values of ``picopose_tpu.utils.torch_export.export_dinov2`` on those
  variables (bitwise: both transpose the same fp32 values), at
  vit_tiny_test and at a 4-block SwiGLU trunk of the same width.
"""

import os
import runpy
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import SMALL, random_flax_variables

from picopose_tpu.models import PicoPose as JaxPicoPose
from picopose_tpu.models import dinov2 as jdinov2
from picopose_tpu.utils.torch_export import export_dinov2 as jax_export_dinov2
from picopose_tpu.utils.torch_export import save_torch_checkpoint as jax_save_torch_checkpoint
from picopose_tpu_torch import export_torch
from picopose_tpu_torch.models import PicoPose
from picopose_tpu_torch.models import dinov2 as tdinov2
from picopose_tpu_torch.train.step import init_state, make_optimizer
from picopose_tpu_torch.utils import checkpoint as ckpt
from picopose_tpu_torch.utils.torch_export import export_dinov2, export_state_dict
from picopose_tpu_torch.utils.weights import load_flax_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPTH = 4  # vit_tiny_test's blocks


@pytest.fixture(scope="module")
def variables():
    return random_flax_variables(JaxPicoPose(**SMALL, compute_dtype=jnp.float32), seed=3)


@pytest.fixture(scope="module")
def reference_ckpt(variables, tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    jax_save_torch_checkpoint(variables, str(d / "jax.ckpt"))
    yield str(d / "jax.ckpt")
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's, emptied when the test ends (a train state's file and the
    exported checkpoints take ~1.1 GB)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _load(path):
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd


def _assert_same_file_contents(got, ref):
    assert got.keys() == ref.keys()
    if "state_dict" in ref:
        got, ref = got["state_dict"], ref["state_dict"]
    assert sorted(got) == sorted(ref)
    for k in ref:
        g, r = got[k], ref[k]
        if k.endswith("num_batches_tracked"):
            assert g.shape == () and r.shape == (1,), k
            g = g.reshape(1)
        assert g.dtype == r.dtype and torch.equal(g, r), k


def _jax_tool(argv):
    """tools/export_torch.py as its command line runs it."""
    saved = sys.argv
    sys.argv = [os.path.join(ROOT, "tools", "export_torch.py"), *argv]
    try:
        runpy.run_path(sys.argv[0], run_name="__main__")
    finally:
        sys.argv = saved


def test_cli_writes_the_jax_tools_checkpoint(reference_ckpt, tmp_path):
    out, ref = str(tmp_path / "port.ckpt"), str(tmp_path / "jax_tool.ckpt")
    env = dict(os.environ, OMP_NUM_THREADS=str(torch.get_num_threads()))
    p = subprocess.run([sys.executable, "-m", "picopose_tpu_torch.export_torch", reference_ckpt, out,
                        "--depth", str(DEPTH)], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == f"wrote {out}"
    _jax_tool([reference_ckpt, ref, "--depth", str(DEPTH)])
    got = _load(out)
    _assert_same_file_contents(got, _load(ref))
    names = got["state_dict"]
    assert all(k.startswith("network.") for k in names)
    assert not any(".refinenet1." in k or "mask_token" in k for k in names)  # dead modules are not written
    tracked = [v for k, v in names.items() if k.endswith("num_batches_tracked")]
    assert tracked and all(int(v) == 0 and v.dtype == torch.int64 for v in tracked)


def test_cli_raw_writes_the_jax_tools_raw_state_dict(reference_ckpt, tmp_path):
    out, ref = str(tmp_path / "port.pth"), str(tmp_path / "jax_tool.pth")
    assert export_torch.main([reference_ckpt, out, "--depth", str(DEPTH), "--raw"]) == out
    _jax_tool([reference_ckpt, ref, "--depth", str(DEPTH), "--raw"])
    got = _load(out)
    assert "state_dict" not in got
    _assert_same_file_contents(got, _load(ref))


def test_a_port_train_state_exports_to_its_models_state_dict(tmp_path):
    state = init_state(make_optimizer(base_lr=1e-3, max_iters=4), 5, device="cpu",
                       compute_dtype=torch.float32, **SMALL)
    path = ckpt.save(str(tmp_path), 3, state, epoch=0)
    out = export_torch.main([path, str(tmp_path / "out.ckpt"), "--depth", str(DEPTH)])
    got = _load(out)["state_dict"]
    ref = export_state_dict(state.model.state_dict())
    assert sorted(got) == sorted(f"network.{k}" for k in ref)
    for k, v in ref.items():
        assert torch.equal(got[f"network.{k}"], torch.from_numpy(v)), k


def test_an_orbax_directory_raises(tmp_path):
    step = tmp_path / "checkpoints" / "40000"
    step.mkdir(parents=True)
    (step / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match=f"{step}: not an orbax checkpoint .neither _METADATA nor default/_METADATA"):
        export_torch.main([str(step), str(tmp_path / "out.ckpt")])
    assert not (tmp_path / "out.ckpt").exists()


SWIGLU_TINY = dict(tdinov2=tdinov2.ViTConfig(128, 4, 4, ffn_layer="swiglufused"),
                   jdinov2=jdinov2.ViTConfig(128, 4, 4, ffn_layer="swiglufused"))


@pytest.mark.parametrize("vit", ["vit_tiny_test", "swiglu_tiny"])
def test_export_dinov2_matches_jax(vit, monkeypatch):
    if vit == "swiglu_tiny":
        monkeypatch.setitem(tdinov2.VIT_CONFIGS, vit, SWIGLU_TINY["tdinov2"])
        monkeypatch.setitem(jdinov2.VIT_CONFIGS, vit, SWIGLU_TINY["jdinov2"])
    small = dict(SMALL, vit_type=vit)
    variables = random_flax_variables(JaxPicoPose(**small, compute_dtype=jnp.float32), seed=7)
    model = PicoPose(**small, compute_dtype=torch.float32, device="cpu")
    load_flax_variables(model, variables)
    prefix = "feature_extractor.dinov2."
    ref = jax_export_dinov2(variables["params"]["feature_extractor"], prefix=prefix)
    for got in (export_dinov2(model.feature_extractor.dinov2, prefix),
                export_dinov2(model.feature_extractor.dinov2.state_dict(), prefix)):
        assert sorted(got) == sorted(ref)
        for k, v in ref.items():
            assert got[k].dtype == np.float32 and np.array_equal(got[k], v), k
    swiglu = any(".mlp.w12." in k for k in ref)
    assert swiglu == (vit == "swiglu_tiny")
