"""The flow decoder as ``cfg.model`` sets it, through the port's entry
points, on the CPU.

The JAX package's run_test.py and run_train.py build ``PicoPose`` with
``cfg.model.num_levels`` and ``cfg.model.radius``; so do the port's
(``models/picopose.py::model_kwargs``).  Here at ``vit_tiny_test`` with
the dataset, the evaluation and the data stood in for, so the model is
checked as built, without a dataset run: ``run_test`` with
``--set model.radius=8`` builds a decoder of lookup radius 4, and
``run_training`` one too (it refused radius 8 before).  A checkpoint of
radius 8, exported as the reference's Lightning ``.ckpt``, loads bitwise
into a radius-8 model, through ``run_test``'s loader and through
``warm_start``; into a radius-4 model both raise naming both shapes.
``run_batch`` with fewer than the DPT's 3 levels raises, where the JAX
package's fails.
"""

import os

import numpy as np
import pytest
import torch
from torch_parity import SMALL

from picopose_tpu_torch import run_test
from picopose_tpu_torch.models import PicoPose
from picopose_tpu_torch.train import loop as T
from picopose_tpu_torch.train import step
from picopose_tpu_torch.utils.checkpoint import load_any
from picopose_tpu_torch.utils.config import load_config
from picopose_tpu_torch.utils.torch_export import save_torch_checkpoint
from picopose_tpu_torch.utils.weights import init_random_, load_flax_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["model.vit_type=vit_tiny_test", "model.blocks_to_take=[0,1,2,3]", "model.compute_dtype=float32"]
CORR_IN = "flow_decoder.encoder.0.corr_net_0.weight"


def _decoder_channels(model):
    fd = model.flow_decoder
    return fd.num_levels, fd.radius, [e.corr_net_0.in_channels for e in fd.encoder]


@pytest.mark.parametrize("overrides,expected", [
    ([], (3, 4, [25, 50, 75])),
    (["model.radius=8"], (3, 8, [81, 162, 243])),
    (["model.radius=6", "model.num_levels=2"], (2, 6, [49, 98])),
])
def test_run_test_builds_the_decoder_the_config_names(tmp_path, monkeypatch, overrides, expected):
    built = []

    def evaluate(model, ds, template_dir, save_path, **kw):
        built.append(model)
        return save_path

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(run_test, "BOPTestDataset", lambda *a, **kw: None)
    monkeypatch.setattr(run_test, "evaluate_dataset", evaluate)
    run_test.main(["--device", "cpu", "--dataset", "fakeds", "--config", os.path.join(ROOT, "configs", "base.yaml"),
                   "--set", *TINY, *overrides])
    (model,) = built
    assert _decoder_channels(model) == expected
    assert model.device.type == "cpu" and model.compute_dtype == torch.float32


def test_run_training_builds_a_radius_8_decoder(tmp_path, monkeypatch):
    """``run_training`` builds its state from ``cfg.model`` (it refused
    radius 8 before); the run is stopped where the data would load."""
    states = []
    real_init = T.init_state

    def init_state(*a, **kw):
        states.append(real_init(*a, **kw))
        return states[-1]

    class Stop(Exception):
        pass

    def no_data(**kw):
        raise Stop

    monkeypatch.setattr(T, "init_state", init_state)
    monkeypatch.setattr(T, "MegaPoseTrainingDataset", no_data)
    cfg = load_config(os.path.join(ROOT, "configs", "base.yaml"), [*TINY, "model.radius=8", "trainer.n_devices=1"])
    with pytest.raises(Stop):
        T.run_training(cfg, str(tmp_path), max_steps=1, device="cpu")
    (state,) = states
    assert _decoder_channels(state.model) == (3, 8, [81, 162, 243])
    assert state.model.training


@pytest.fixture(scope="module")
def radius_8_checkpoint(tmp_path_factory):
    model = PicoPose(**SMALL, compute_dtype=torch.float32, device="cpu", radius=8)
    init_random_(model, 3)
    path = str(tmp_path_factory.mktemp("ckpt") / "radius8.ckpt")
    save_torch_checkpoint(model, path)
    return path, {k: v.clone() for k, v in model.state_dict().items()}


def test_a_radius_8_checkpoint_loads_into_a_radius_8_model(radius_8_checkpoint):
    path, ref = radius_8_checkpoint
    model = PicoPose(**SMALL, compute_dtype=torch.float32, device="cpu", radius=8)
    load_flax_variables(model, load_any(path, depth=4))  # run_test's loader
    state = step.init_state(step.make_optimizer(), device="cpu", **SMALL, compute_dtype=torch.float32, radius=8)
    T.warm_start(state, path)
    for got in (model.state_dict(), state.model.state_dict()):
        assert sorted(got) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy(), err_msg=k)


def test_a_radius_8_checkpoint_into_a_radius_4_model_names_both_shapes(radius_8_checkpoint):
    path, _ = radius_8_checkpoint
    model = PicoPose(**SMALL, compute_dtype=torch.float32, device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    shapes = r"\(256, 81, 1, 1\) vs model \(256, 25, 1, 1\)"
    with pytest.raises(ValueError, match=rf"{CORR_IN}: checkpoint {shapes}"):
        load_flax_variables(model, load_any(path, depth=4))
    state = step.init_state(step.make_optimizer(), device="cpu", **SMALL, compute_dtype=torch.float32)
    with pytest.raises(ValueError, match=rf"{CORR_IN}: checkpoint {shapes}"):
        T.warm_start(state, path)
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())


def test_run_batch_needs_the_finest_decoder_level():
    """With fewer than 3 levels the finest flow misses the bank's 64^2
    points: the JAX package's run_batch fails there (its validity mask of
    32^2 cells against 64^2 template points, picopose_tpu/eval/pipeline.py
    :161-197), the port's raises naming both grids; the decoder itself
    runs (tests/test_torch_flow.py)."""
    from test_torch_graphs import _bank_arrays, _batch

    from picopose_tpu_torch.eval.pipeline import build_bank, run_batch

    model = PicoPose(**SMALL, compute_dtype=torch.float32, device="cpu", num_levels=2)
    init_random_(model, 0)
    rng = np.random.default_rng(3)
    bank = build_bank(model, *_bank_arrays(rng), chunk=4)
    with pytest.raises(ValueError, match=r"\(32, 32\) cells and the bank's points \(64, 64\)"):
        run_batch(model, _batch(rng), bank, hyp=2, pnp_iters=8)
