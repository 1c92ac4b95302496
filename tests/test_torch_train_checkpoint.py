"""Train-state checkpoints (picopose_tpu_torch/utils/checkpoint.py) at
vit_tiny_test on the CPU, with real steps on a batch of the small MegaPose
tree (tests/torch_bop_tree.py::write_megapose_tree); the training CLI is
tests/test_torch_run_train.py.

Tolerance: bitwise.  A restored state has the saved parameters, BatchNorm
statistics, optimizer moments, update count (the schedule's position),
``mini_step``, accumulated gradients and step, and its next step equals
the next step of the state it was saved from.  ``load_any``, ``warm_start`` and
``PoseEstimator(checkpoint=)`` read a saved file's weights.  A train state
of this model is ~850 MB: every test removes the files it wrote.
"""

import os
import shutil

import pytest
import torch
from torch_bop_tree import write_megapose_tree

from picopose_tpu_torch.data.megapose import MegaPoseTrainingDataset, collate
from picopose_tpu_torch.models.dinov2 import VIT_CONFIGS
from picopose_tpu_torch.serve import PoseEstimator
from picopose_tpu_torch.train.loop import warm_start
from picopose_tpu_torch.train.step import init_state, make_optimizer, train_step
from picopose_tpu_torch.utils import checkpoint as ckpt
from picopose_tpu_torch.utils.weights import load_flax_variables

SMALL = dict(vit_type="vit_tiny_test", blocks_to_take=(0, 1, 2, 3), compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_megapose_tree(str(tmp_path_factory.mktemp("mp")))


@pytest.fixture(scope="module")
def batch(tree):
    ds = MegaPoseTrainingDataset(tree, seed=2, min_px_count_visib=100)
    return collate([ds.get(0)])


@pytest.fixture
def log_dir(tmp_path):
    yield str(tmp_path)
    shutil.rmtree(tmp_path, ignore_errors=True)


def _state(seed, grad_accum=1):
    tx = make_optimizer(base_lr=1e-3, max_iters=10, warmup_iters=2, grad_accum=grad_accum)
    return init_state(tx, seed, device="cpu", **SMALL)


def _noise(seed):
    return torch.Generator().manual_seed(seed)


def _assert_states_equal(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer, b.optimizer
    assert oa.mini_step == ob.mini_step and a.step == b.step
    assert oa.updates == ob.updates and torch.equal(oa.count, ob.count)  # the schedule's position
    for pa, pb, ga, gb in zip(oa.params, ob.params, oa.grads, ob.grads):
        assert pa.grad is ga and pb.grad is gb
        assert torch.equal(ga, gb)
    assert oa.moments.keys() == ob.moments.keys()
    for k in oa.moments:
        for ma, mb in zip(oa.moments[k], ob.moments[k]):
            assert torch.equal(ma, mb), k


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_restore_is_bitwise_and_the_next_step_equal(batch, log_dir, grad_accum):
    """With grad_accum 2 the save falls in the middle of an accumulation:
    the summed gradients travel with it."""
    a = _state(0, grad_accum)
    train_step(a, batch, _noise(0))
    assert a.optimizer.mini_step == (1 if grad_accum == 2 else 0)
    path = ckpt.save(log_dir, a.step, a, epoch=0)
    assert path == os.path.join(log_dir, "checkpoints", f"{a.step}.pt") and ckpt.latest_step(log_dir) == a.step
    b = _state(1, grad_accum)  # other weights
    ckpt.restore(log_dir, None, b)
    _assert_states_equal(a, b)
    la, lb = train_step(a, batch, _noise(9)), train_step(b, batch, _noise(9))
    for k in la:
        assert torch.equal(la[k], lb[k]), k
    _assert_states_equal(a, b)


def test_every_save_is_kept_and_files_read_back(batch, log_dir):
    """Two saves both stay; load_any, warm_start and PoseEstimator read the
    weights of the file they are given."""
    state = _state(0)
    ckpt.save(log_dir, 1, state, epoch=0)
    train_step(state, batch, _noise(0))
    path = ckpt.save(log_dir, 2, state, epoch=1)
    assert sorted(os.listdir(os.path.join(log_dir, "checkpoints"))) == ["1.pt", "2.pt"]
    assert ckpt.latest_step(log_dir) == 2
    want = state.model.state_dict()

    def assert_weights(model, what):
        got = model.state_dict()
        assert got.keys() == want.keys(), what
        for k in want:
            assert torch.equal(got[k], want[k]), f"{what} {k}"

    fresh = _state(5).model
    load_flax_variables(fresh, ckpt.load_any(path, depth=VIT_CONFIGS["vit_tiny_test"].depth))
    assert_weights(fresh, "load_any")
    assert_weights(warm_start(_state(6), path).model, "warm_start")
    est = PoseEstimator(**{**SMALL, "compute_dtype": "float32"}, device="cpu", checkpoint=path)
    assert_weights(est.model, "PoseEstimator")
    # the first save holds the untrained weights
    first = _state(5).model
    load_flax_variables(first, ckpt.load_any(os.path.join(log_dir, "checkpoints", "1.pt"), depth=4))
    assert not torch.equal(first.flow_decoder.proj_conv[0].weight, state.model.flow_decoder.proj_conv[0].weight)
