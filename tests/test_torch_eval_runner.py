"""The port's BOP evaluation (eval/runner.py, run_test.py, register_object)
against the JAX package's, on the CPU.

The small model (vit_tiny_test, fp32) at the same seeded weights, with
the stage-3 heads' predict convs scaled (kernels x0.01, mask bias 4) so
PnP sees thousands of correspondences, runs the tree of
tests/torch_bop_tree.py (6 views per object, three frames) with hyp 2,
batches of 2 (each object's last batch padded) and 16 PnP iterations.
The JAX runner's draws are recovered from its key (``key, sub =
split(key)`` per batch) and injected into the port's runner.  The JAX
crops take their cv2 path (PICOPOSE_NO_FASTPATH=1), the oracle the port's
crops are held to (tests/test_torch_serve.py).

The runner's multi-device branch (``use_mesh=True``) on two devices
against the JAX runner's on a 2-device mesh, with ``batch_size`` 1
rounded up to 2 by both (the batches of the one-device runs above): the
JAX draws of each batch's global rows are served to the port's two parts
in row order.

Tolerances: the CSV's rows in the same order with the first four columns
(scene, image, object, score) identical; R within 5e-3 and t within 1e-3
m, those of tests/test_torch_run_batch.py; times positive.
``register_object``'s bank: the template arrays it is built from within
1e-5 of the JAX estimator's (they are equal: 0.0; poses and intrinsics
compared exactly), its ViT taps and DPT pyramids within the fp32 feature
tolerance of tests/test_torch_pipeline.py (atol 5e-5 + rtol 1e-5; 1.8e-5
measured: another summation order through the trunk).  ``python -m picopose_tpu_torch.run_test``
with a checkpoint the JAX package exported writes its CSV where the JAX
entry point would, with the in-process run's first four columns.
"""

import csv
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_bop_tree import write_bop_tree
from torch_parity import SMALL, jax_pnp_draws, random_flax_variables

from picopose_tpu.data.bop import BOPTestDataset as JaxDataset
from picopose_tpu.eval.runner import evaluate_dataset as jax_evaluate_dataset
from picopose_tpu.models import PicoPose as JaxPicoPose
from picopose_tpu.serve import PoseEstimator as JaxPoseEstimator
from picopose_tpu.utils.torch_export import save_torch_checkpoint as jax_save_torch_checkpoint
from picopose_tpu_torch import run_test
from picopose_tpu_torch.data.bop import BOPTestDataset
from picopose_tpu_torch.eval.runner import evaluate_dataset
from picopose_tpu_torch.models import PicoPose
from picopose_tpu_torch.serve import PoseEstimator
from picopose_tpu_torch.utils.weights import load_flax_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HYP, ITERS, BATCH, VIEWS = 2, 16, 2, 6


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_bop_tree(str(tmp_path_factory.mktemp("bop")), n_views=VIEWS)


@pytest.fixture(scope="module")
def weights():
    jmodel = JaxPicoPose(**SMALL, compute_dtype=jnp.float32)
    variables = random_flax_variables(jmodel, seed=0)
    fd = variables["params"]["flow_decoder"]
    for l in range(3):
        fd[f"flow_pred_{l}"]["predict"]["kernel"] *= 0.01
        fd[f"mask_pred_{l}"]["predict"]["bias"][:] = 4.0
    return jmodel, variables


def read_csv(path):
    with open(path) as f:
        return list(csv.reader(f))


def pose_of(row):
    return np.array(row[4].split(), float).reshape(3, 3), np.array(row[5].split(), float) / 1000.0


@pytest.fixture(scope="module")
def csvs(tree, weights, tmp_path_factory):
    jmodel, variables = weights
    out = tmp_path_factory.mktemp("csv")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PICOPOSE_NO_FASTPATH", "1")
        jds = JaxDataset(tree["data_dir"], "fakeds", tree["det_path"], n_template_view=VIEWS)
        ref = jax_evaluate_dataset(
            jmodel, variables, jds, tree["template_dir"], str(out / "jax.csv"), jax.random.PRNGKey(0),
            hyp=HYP, batch_size=BATCH, pnp_iters=ITERS, progress=False, use_mesh=False, decode_workers=2,
        )
    key = [jax.random.PRNGKey(0)]

    def draws(valid):  # the JAX runner's per-batch key, split in the same order
        key[0], sub = jax.random.split(key[0])
        return tuple(torch.from_numpy(a).long() for a in jax_pnp_draws(sub, valid.numpy(), ITERS))

    model = PicoPose(**SMALL, compute_dtype=torch.float32, device="cpu")
    load_flax_variables(model, variables)
    ds = BOPTestDataset(tree["data_dir"], "fakeds", tree["det_path"], n_template_view=VIEWS)
    got = evaluate_dataset(
        model, ds, tree["template_dir"], str(out / "port.csv"), hyp=HYP, batch_size=BATCH,
        pnp_iters=ITERS, progress=False, decode_workers=2, pnp_draws=draws,
    )
    return read_csv(got), read_csv(ref)


def test_csv_rows_match_the_jax_runner(csvs):
    got, ref = csvs
    assert len(got) == len(ref) == 6  # obj 1: 3 instances (one padded batch), obj 3: 3
    assert [r[:4] for r in got] == [r[:4] for r in ref]
    for g, r in zip(got, ref):
        assert len(g) == 7
        (R, t), (r_R, r_t) = pose_of(g), pose_of(r)
        np.testing.assert_allclose(R, r_R, atol=5e-3, err_msg=f"R of {g[:3]}")
        np.testing.assert_allclose(t, r_t, atol=1e-3, err_msg=f"t of {g[:3]}")
        assert np.abs(R.T @ R - np.eye(3)).max() < 1e-4
        assert float(g[6]) > 0.25  # model time + the detector's seg_time (>= 0.25 s)


def test_rows_of_one_image_share_its_time(csvs):
    got, _ = csvs
    times = {}
    for row in got:
        times.setdefault((row[0], row[1]), set()).add(row[6])
    assert len(times) == 3 and all(len(v) == 1 for v in times.values())


def test_register_object_builds_the_jax_bank(tree, weights):
    jmodel, variables = weights
    kw = dict(vit_type=SMALL["vit_type"], blocks_to_take=SMALL["blocks_to_take"], compute_dtype="float32",
              n_template_view=VIEWS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PICOPOSE_NO_FASTPATH", "1")
        jest = JaxPoseEstimator(variables=variables, **kw)
        jest.register_object(3, tree["template_dir"])
    est = PoseEstimator(variables=variables, **kw, device="cpu")
    est.register_object(3, tree["template_dir"])
    assert est.objects == [3]
    got, ref = est._banks[3], jest._banks[3]
    for a, b in zip(got.feats + got.dpt, ref.feats + ref.dpt):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5, rtol=1e-5)
    for name in ("mask", "pts3d", "pose", "K", "M"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)), atol=1e-5,
                                   err_msg=name)
    np.testing.assert_array_equal(got.pose.numpy(), np.asarray(ref.pose))
    np.testing.assert_array_equal(got.K.numpy(), np.asarray(ref.K))


def _cli_args(tree, version):
    return [
        "--dataset", "fakeds", "--batch", "2", "--version_id", str(version), "--device", "cpu",
        "--config", os.path.join(ROOT, "configs", "base.yaml"),
        "--set", f"test_dataset.data_dir={tree['data_dir']}",
        f"test_dataset.template_dir={tree['template_root']}",
        f"test_dataset.detection_dir={tree['det_dir']}", f"test_dataset.n_template_view={VIEWS}",
        f"model.vit_type={SMALL['vit_type']}", "model.blocks_to_take=[0,1,2,3]",
        "model.compute_dtype=float32", f"model.hypothesis={HYP}",
    ]


def test_cli_writes_the_csv_where_the_jax_entry_point_would(tree, weights, csvs, tmp_path):
    ckpt = tmp_path / "model.ckpt"
    jax_save_torch_checkpoint(weights[1], str(ckpt))
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run(
        [sys.executable, "-m", "picopose_tpu_torch.run_test", *_cli_args(tree, 3),
         "--checkpoint_path", str(ckpt)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert f"loading checkpoint {ckpt}" in r.stdout
    path = tmp_path / "log" / "picopose" / "version_3" / "fakeds_eval" / "picopose-stage3-2hyp_fakeds-test.csv"
    rows = read_csv(path)
    assert [row[:4] for row in rows] == [row[:4] for row in csvs[0]]
    for row in rows:
        R, t = pose_of(row)
        assert np.abs(R.T @ R - np.eye(3)).max() < 1e-4 and np.isfinite(t).all() and float(row[6]) > 0


def test_cli_checkpoint_resolution(tree, tmp_path, monkeypatch, capsys):
    """--checkpoint_path none: random weights (with the warning) when the
    version has no checkpoints; a step directory found there is read as
    an orbax checkpoint, and one that is not raises with its path."""
    monkeypatch.chdir(tmp_path)
    out = run_test.main(_cli_args(tree, 4) + ["--hyp", "1"])
    assert "WARNING: random init" in capsys.readouterr().out
    assert out == [os.path.join("log", "picopose", "version_4", "fakeds_eval",
                                "picopose-stage3-1hyp_fakeds-test.csv")]
    assert len(read_csv(out[0])) == 6
    os.makedirs(tmp_path / "log" / "picopose" / "version_5" / "checkpoints" / "40")
    with pytest.raises(ValueError, match=os.path.join("version_5", "checkpoints", "40") + ": not an orbax checkpoint"):
        run_test.main(_cli_args(tree, 5))


def test_mesh_branch_matches_the_jax_runner_on_a_two_device_mesh(tree, weights, tmp_path, monkeypatch):
    """Batches of 1 rounded up to 2, each split into two parts of one row:
    on the CPU the parts run on ``cpu`` and ``cpu:0`` (a replica, its own
    bank copy and graphs), as on two cards."""
    import picopose_tpu.parallel.mesh as jax_mesh

    jmodel, variables = weights
    monkeypatch.setenv("PICOPOSE_NO_FASTPATH", "1")
    make = jax_mesh.make_mesh
    monkeypatch.setattr(jax_mesh, "make_mesh", lambda: make(n_data=2, devices=jax.devices()[:2]))
    jds = JaxDataset(tree["data_dir"], "fakeds", tree["det_path"], n_template_view=VIEWS)
    ref = read_csv(jax_evaluate_dataset(
        jmodel, variables, jds, tree["template_dir"], str(tmp_path / "jax.csv"), jax.random.PRNGKey(0),
        hyp=HYP, batch_size=1, pnp_iters=ITERS, progress=False, use_mesh=True, decode_workers=2,
    ))
    monkeypatch.delenv("PICOPOSE_NO_FASTPATH")
    state = {"key": jax.random.PRNGKey(0), "row": 0}
    total = 2 * HYP  # PnP rows of a batch of 2

    def draws(valid):  # this part's rows of the draws the JAX runner makes for the whole batch
        if state["row"] == 0:
            state["key"], state["sub"] = jax.random.split(state["key"])
        n, at = valid.shape[0], state["row"]
        full = np.repeat(valid.numpy()[:1], total, axis=0)
        full[at:at + n] = valid.numpy()
        sample, subset = jax_pnp_draws(state["sub"], full, ITERS)
        state["row"] = (at + n) % total
        return torch.from_numpy(sample[at:at + n]).long(), torch.from_numpy(subset[at:at + n]).long()

    model = PicoPose(**SMALL, compute_dtype=torch.float32, device="cpu")
    load_flax_variables(model, variables)
    ds = BOPTestDataset(tree["data_dir"], "fakeds", tree["det_path"], n_template_view=VIEWS)
    got = read_csv(evaluate_dataset(
        model, ds, tree["template_dir"], str(tmp_path / "port.csv"), hyp=HYP, batch_size=1, pnp_iters=ITERS,
        progress=False, decode_workers=2, pnp_draws=draws, use_mesh=True,
        devices=[torch.device("cpu"), torch.device("cpu", 0)],
    ))
    assert len(got) == len(ref) == 6 and [r[:4] for r in got] == [r[:4] for r in ref]
    for g, r in zip(got, ref):
        (R, t), (r_R, r_t) = pose_of(g), pose_of(r)
        np.testing.assert_allclose(R, r_R, atol=5e-3, err_msg=f"R of {g[:3]}")
        np.testing.assert_allclose(t, r_t, atol=1e-3, err_msg=f"t of {g[:3]}")


def test_raw_image_cache_decodes_each_frame_once():
    """Threads asking for frames at once (four times the cores, the
    interpreter switching threads every microsecond) decode each frame
    once and all get it; a decode error reaches every thread that waited
    on it, and the next request decodes again."""
    import sys
    import threading
    import time

    from picopose_tpu_torch.eval.runner import RawImageCache

    class Frames:
        calls, fail, waiters = [], False, 0

        def load_raw(self, index):
            self.calls.append(index)
            time.sleep(0.05)
            # a failing decode ends only when every other thread waits on it (on a
            # loaded host a thread may start after 0.05 s, and would decode again)
            deadline = time.monotonic() + 10
            while self.fail and cache.hits < self.waiters and time.monotonic() < deadline:
                time.sleep(0.001)
            if self.fail:
                raise OSError(f"frame {index}")
            return np.full((2, 2, 3), index, np.uint8), np.eye(3)

    frames = Frames()
    cache = RawImageCache(frames)
    out, errors = [], []

    def ask(index):
        try:
            out.append((index, cache.get(index)[0][0, 0, 0]))
        except OSError as e:
            errors.append(str(e))

    n = 4 * (os.cpu_count() or 1)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for fail, indices in ((False, (1, 3, 5)), (True, (2,))):
            frames.fail, frames.waiters = fail, cache.hits + n - 1
            threads = [threading.Thread(target=ask, args=(indices[k % len(indices)],)) for k in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert sorted(frames.calls) == [1, 2, 3, 5]
    assert sorted(out) == sorted((i, i) for k in range(n) for i in [(1, 3, 5)[k % 3]])
    assert errors == ["frame 2"] * n
    assert cache.misses == 3 and cache.hits == 2 * n - 4
    frames.fail = False
    assert cache.get(2)[0][0, 0, 0] == 2 and sorted(frames.calls) == [1, 2, 2, 3, 5]
