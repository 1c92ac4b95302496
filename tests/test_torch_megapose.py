"""The port's MegaPose training data (picopose_tpu_torch/data/megapose.py,
geom/templates.py) against the JAX package's on one small tree.

The tree (tests/torch_bop_tree.py::write_megapose_tree) holds ten JPEG
frames of textured spheres, two of them invalid (below the visibility
threshold; no depth file), and a 162-view level-1 template bank.

Tolerances: the pose tables, every sample key, the generators' states and
``collate`` bitwise.  Both packages crop through their C++ fast path by
default (picopose_tpu/data/crops.py:86-93, picopose_tpu_torch/data/
crops.py); ``PICOPOSE_NO_FASTPATH=1`` sends both to their numpy (cv2)
path.  The sample tests pin both numpy paths (``cv2_crops``) and hold the
samples bitwise; one test holds the C++ crops of both packages bitwise,
and the port's numpy crops against the JAX package's C++ ones with the
``*_rgb`` crops within 2e-4 (the rest bitwise).
"""

import os

import numpy as np
import pytest
from torch_bop_tree import write_megapose_tree

from picopose_tpu.data import megapose as J
from picopose_tpu.geom import templates as JT
from picopose_tpu.native import fastpath
from picopose_tpu_torch.data import megapose as T
from picopose_tpu_torch.geom import templates as TT
from picopose_tpu_torch.native import fastpath as port_fastpath

KW = dict(min_px_count_visib=100)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_megapose_tree(str(tmp_path_factory.mktemp("mp")))


@pytest.fixture
def cv2_crops(monkeypatch):
    monkeypatch.setenv("PICOPOSE_NO_FASTPATH", "1")
    assert not fastpath.accelerated() and not port_fastpath.accelerated()


def _assert_samples_equal(got, ref, rgb_atol=0.0, what=""):
    assert (got is None) == (ref is None), what
    if ref is None:
        return
    assert got.keys() == ref.keys(), what
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, f"{what} {k}"
        if rgb_atol and k.endswith("_rgb"):
            np.testing.assert_allclose(got[k], ref[k], atol=rgb_atol, rtol=0, err_msg=f"{what} {k}")
        else:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{what} {k}")


@pytest.mark.parametrize("level", [0, 1, 2])
def test_template_object_poses_are_the_jax_tables(level):
    np.testing.assert_array_equal(TT.template_object_poses(level), JT.template_object_poses(level))


def test_load_pose_table(tree):
    path = os.path.join(tree, "MegaPose-Templates", "GSO", "object_poses", "000001.npy")
    np.testing.assert_array_equal(TT.load_pose_table(path), JT.load_pose_table(path))
    np.save(path + ".bad.npy", np.zeros((3, 4)))
    for mod in (TT, JT):
        with pytest.raises(ValueError, match="must be"):
            mod.load_pose_table(path + ".bad.npy")


@pytest.mark.parametrize("augment_real", [False, True])
def test_an_epoch_of_samples_is_the_jax_one(tree, cv2_crops, augment_real):
    port = T.MegaPoseTrainingDataset(tree, seed=3, augment_real=augment_real, **KW)
    jax = J.MegaPoseTrainingDataset(tree, seed=3, augment_real=augment_real, **KW)
    np.testing.assert_array_equal(port.template_z, jax.template_z)
    for epoch in range(2):
        np.testing.assert_array_equal(port.epoch_idx, jax.epoch_idx)
        for i in range(len(port)):
            _assert_samples_equal(port.get(i), jax.get(i), what=f"epoch {epoch} sample {i}")
            assert port.rng.bit_generator.state == jax.rng.bit_generator.state
        port.reset()
        jax.reset()
        assert port.rng.bit_generator.state == jax.rng.bit_generator.state


@pytest.mark.parametrize("port_crops", ["cpp", "numpy"])
def test_samples_with_the_native_crops(tree, monkeypatch, port_crops):
    """The JAX package's C++ crops against the port's: its C++ crops
    bitwise, its numpy crops with ``*_rgb`` within 2e-4."""
    monkeypatch.delenv("PICOPOSE_NO_FASTPATH", raising=False)
    if port_crops == "numpy":
        monkeypatch.setattr(port_fastpath, "accelerated", lambda: False)
    assert fastpath.accelerated()
    port = T.MegaPoseTrainingDataset(tree, seed=5, augment_real=True, **KW)
    jax = J.MegaPoseTrainingDataset(tree, seed=5, augment_real=True, **KW)
    for i in range(6):
        _assert_samples_equal(port.get(i), jax.get(i), rgb_atol=2e-4 if port_crops == "numpy" else 0.0,
                              what=f"sample {i}")


def test_reset_resamples_as_jax(tree):
    for n in (-1, 4, 25):  # the whole set, a subset, more than there are (with replacement)
        port = T.MegaPoseTrainingDataset(tree, seed=11, num_img_per_epoch=n, **KW)
        jax = J.MegaPoseTrainingDataset(tree, seed=11, num_img_per_epoch=n, **KW)
        assert len(port) == len(jax)
        for _ in range(3):
            port.reset()
            jax.reset()
            np.testing.assert_array_equal(port.epoch_idx, jax.epoch_idx)


def test_invalid_samples_are_retried_as_in_jax(tree, cv2_crops):
    port = T.MegaPoseTrainingDataset(tree, seed=0, **KW)
    jax = J.MegaPoseTrainingDataset(tree, seed=0, **KW)
    heads = [h for _, h in port.samples]
    invalid = [i for i, h in enumerate(heads) if h.endswith(("00000001", "00000002"))]
    assert len(invalid) == 2
    for i in invalid:  # below the visibility threshold; no depth file
        assert port._read(i) is None and jax._read(i) is None
    for index in np.flatnonzero(np.isin(port.epoch_idx, invalid)):
        _assert_samples_equal(port.get(int(index)), jax.get(int(index)), what=f"index {index}")
        assert port.rng.bit_generator.state == jax.rng.bit_generator.state
    # a tree with nothing valid: 64 tries, then None
    empty = T.MegaPoseTrainingDataset(tree, seed=0, min_px_count_visib=10**9)
    assert empty.get(0) is None


def test_template_cache_is_exact(tree):
    """Cached template samples are bit-identical to uncached loads
    (tests/test_integration_io.py::test_template_cache_exact)."""
    cached = T.MegaPoseTrainingDataset(tree, seed=3, augment_real=False, **KW)
    uncached = T.MegaPoseTrainingDataset(tree, seed=3, augment_real=False, cache_templates=0, **KW)
    for i in [0, 3, 0, 3, 0, 5]:  # revisits hit the cache
        _assert_samples_equal(cached.get(i), uncached.get(i), what=f"sample {i}")
    assert len(cached._tem_cache) > 0 and len(uncached._tem_cache) == 0


def test_collate_pads_depth_as_jax(tree, cv2_crops):
    ds = T.MegaPoseTrainingDataset(tree, seed=1, **KW)
    samples = [ds.get(i) for i in range(3)]
    small = dict(samples[2])
    small["real_full_depth"] = samples[2]["real_full_depth"][:50, :70]
    small["tem_full_depth"] = samples[2]["tem_full_depth"][:300, :10]
    samples[2] = small
    got, ref = T.collate(samples), J.collate(samples)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["real_full_depth"].shape == (3, 120, 160)
    assert not got["real_full_depth"][2, 50:].any() and not got["real_full_depth"][2, :, 70:].any()
