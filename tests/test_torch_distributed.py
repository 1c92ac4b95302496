"""The port's sharded training step over ranks (parallel/, train/step.py's
``make_train_step(state, shardings, mesh)``), on the CPU in gloo groups of
spawned processes (tests/torch_dist_worker.py): ddp, fsdp and tp over 2
ranks, fsdp_tp over 2 x 2; against the JAX package's sharded
``make_train_step`` on a 2-device mesh and against the port's
one-process step at the global batch.

The setting of tests/test_torch_train_compiled.py: ``vit_tiny_test``,
fp32, seeded flax variables, a global batch of 2 synthetic sphere pairs
(one row per data rank; under tp both model ranks hold both rows), the
JAX package's affine-noise draws injected, AdamW at lr 1e-3 with
``grad_accum`` 2 over three steps (step 1 accumulates, step 2 updates,
step 3 accumulates).  The JAX program runs in its fsdp mode; its modes
compute the same step (tests/test_parallel_modes.py), and every port mode
is held to it.

Tolerances (measured largest errors in brackets):
* against the JAX sharded step, test_torch_train_compiled.py's: each loss
  of the two steps before the update within 1e-4 relative [4.0e-6]; the
  BatchNorm statistics of those steps within 1e-5; after the update the
  change of the state within 1e-2 relative RMS per parameter group
  [2.6e-3, fsdp_tp] and each parameter within 2 lr; the losses of the
  step after the update within 2e-4 [1.16e-4, fsdp_tp: the update moves
  parameters whose gradient is near zero by +-lr, and the sharded sums'
  order flips some of them; ddp 5.8e-5];
* against the port's one-process step at the global batch, fp32
  reduction order: the losses of the steps before the update within 1e-5
  relative [1.1e-6], of the step after it within 1e-4 [7.2e-5]; the
  gradient of step 1 (summed over the ranks) within 1e-3 relative RMS per
  group, test_torch_train_step.py's gradient tolerance [the DPT head:
  9.2e-5 under ddp, 1.6e-4 under tp, whose row-parallel sums add in
  another order];
* across ranks: the replicated parameters and the BatchNorm statistics
  bitwise; each split leaf's part its share of the leaf (tp splits qkv
  and the affine head's fc1 among others); under fsdp the bytes a rank
  holds (parameters, moments, gradients) at most 0.6 of ddp's;
* the checkpoint rank 0 wrote after the third step (in the middle of an
  accumulation) of fsdp over 2 ranks and of fsdp_tp over 2 x 2: the
  one-device file's keys, shapes and counters, its values within the
  tolerances above; restored bitwise at world size 1 (here) and at its
  own in another layout (the fsdp file under tp 1 x 2, the fsdp_tp file
  under ddp 4 x 1, in the workers);
* a JAX training run resumed over the ranks: the committed orbax
  fixtures (tests/make_orbax_fixture.py: one process's save, and two
  processes' save over a 2 x 2 fsdp_tp mesh), each rank reading only the
  chunks that meet its part, restore in ddp, fsdp and tp over 2 ranks (a
  group of their own, beside the training runs) and in fsdp_tp and ddp
  over 4, bitwise the port's one-process restore of the fixture (saved
  here as a ``.pt`` file and restored in the same layout); the step from
  the two processes' save is bitwise the step from the ``.pt``.

``python -m torch.distributed.run --nproc_per_node 2 -m
picopose_tpu_torch.run_train --dist_backend gloo`` with
``trainer.n_devices=2`` trains two steps of the global batch 2 on the
MegaPose tree of tests/torch_bop_tree.py; its checkpoint follows the
one-process run at ``bs`` 2 (the state tolerances above at its lr).
"""

import multiprocessing as mp
import os
import pickle
import shutil
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist_worker as worker
from test_torch_train_losses import jax_affine_noise
from test_torch_train_step import _batch, _rel_rms_by_group
from torch_bop_tree import write_megapose_tree
from torch_parity import SMALL, random_flax_variables

from picopose_tpu.models import PicoPose as JaxPicoPose
from picopose_tpu.parallel.mesh import make_mesh as jax_make_mesh
from picopose_tpu.parallel.mesh import shard_batch as jax_shard_batch
from picopose_tpu.parallel.shardings import shard_state as jax_shard_state
from picopose_tpu.parallel.shardings import state_shardings as jax_state_shardings
from picopose_tpu.train import step as js
from picopose_tpu_torch.train import loop as T
from picopose_tpu_torch.train import step as ts
from picopose_tpu_torch.utils import checkpoint as ckpt
from picopose_tpu_torch.utils.config import load_config
from picopose_tpu_torch.utils.weights import state_dict_from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
B = 2
LR = worker.OPT["base_lr"]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _params(model) -> set:
    return {n for n, _ in model.named_parameters()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the ranks of both worlds, then compute the JAX sharded steps
    and the port's one-process steps here while they run.  The ~6 GB of
    states and checkpoints written are removed at the end, a failure
    included."""
    work = str(tmp_path_factory.mktemp("ranks"))
    try:
        yield from _runs(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _runs(work):
    jmodel = JaxPicoPose(**SMALL, compute_dtype=jnp.float32)
    variables = random_flax_variables(jmodel, seed=0)
    batch = _batch()
    keys = [jax.random.PRNGKey(20 + i) for i in range(worker.STEPS)]
    noises = [jax_affine_noise(jax.random.split(k)[0], B) for k in keys]
    initial = state_dict_from_flax(variables)
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in initial.items()},
               os.path.join(work, "weights.pt"))
    np.savez(os.path.join(work, "batch.npz"), **batch)
    with open(os.path.join(work, "noise.pkl"), "wb") as f:
        pickle.dump([tuple(t.numpy() for t in n) for n in noises], f)
    state = worker.fresh_state(work)  # the orbax fixture's one-process restore, as the ranks' reference
    ckpt.restore(worker.ORBAX["orbax_small"], None, state)
    ckpt.save(os.path.join(work, worker.PT), state.step, state, 0)
    del state

    ctx = mp.get_context("spawn")
    procs = []
    for world, task in worker.GROUPS:
        port = free_port()
        procs += [ctx.Process(target=worker.main, args=(r, world, port, work, task)) for r in range(world)]
    for p in procs:
        p.start()
    try:
        # the JAX package's sharded step on a 2-device mesh
        tx = js.make_optimizer(**worker.OPT, grad_accum=2)
        mesh = jax_make_mesh(n_data=2, devices=jax.devices()[:2])
        params = jax.tree.map(jnp.asarray, variables["params"])
        jstate = js.TrainState(jnp.zeros((), jnp.int32), params, jax.tree.map(jnp.asarray, variables["batch_stats"]),
                               tx.init(params))
        jstate = jax_shard_state(jstate, mesh, "fsdp")
        jstep = js.make_train_step(jmodel, tx, jax_state_shardings(mesh, jstate, "fsdp"), mesh)
        jb = jax_shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
        ref = []
        with mesh:
            for k in keys:
                jstate, losses = jstep(jstate, jb, k)
                ref.append(dict(losses={n: float(v) for n, v in losses.items()}, state=state_dict_from_flax(
                    {"params": jstate.params, "batch_stats": jstate.batch_stats})))

        # the port's one-process step at the global batch
        state = worker.fresh_state(work)
        step = ts.make_train_step(state)
        one = {"losses": [], "stats": []}
        for i, n in enumerate(noises):
            one["losses"].append({k: float(v) for k, v in step(state, batch, n).items()})
            sd = {k: v.clone() for k, v in state.model.state_dict().items()}
            one["stats"].append({k: v for k, v in sd.items() if "running" in k})
            if i == 0:
                one["grads"] = {name: p.grad.clone() for name, p in state.model.named_parameters()}
            if i == 1:
                one["updated"] = sd
        one["ckpt"] = ckpt.save(os.path.join(work, "ckpt_one"), state.step, state, 0)
    finally:
        for p in procs:
            p.join(timeout=900)
    codes = [p.exitcode for p in procs]
    assert codes == [0] * len(procs), f"a rank failed (exit codes {codes}): see its traceback above"
    groups = {}
    for world, task in worker.GROUPS:
        groups[world, task] = []
        for r in range(world):
            with open(os.path.join(work, f"{task}{world}_rank{r}.pkl"), "rb") as f:
                groups[world, task].append(pickle.load(f))
    worlds = {world: groups[world, "train"] for world in worker.WORLDS}
    orbax = {world: [r["orbax"] for r in groups[world, "orbax" if world in worker.ORBAX_APART else "train"]]
             for world in worker.ORBAX_LAYOUTS}
    tensors = {}
    for m in worker.MODES:  # into memory, off the disk
        tensors[m] = torch.load(os.path.join(work, f"{m}.pt"), weights_only=True)
        os.remove(os.path.join(work, f"{m}.pt"))
    yield dict(work=work, initial=initial, ref=ref, one=one, worlds=worlds, orbax=orbax, groups=groups,
               tensors=tensors, batch=batch, params=_params(state.model))


def _ranks(runs, mode):
    """Every rank's results of ``mode``'s run."""
    world = next(w for w, plan in worker.WORLDS.items() if mode in [r[0] for r in plan["runs"]])
    return [r[mode] for r in runs["worlds"][world]]


@pytest.mark.parametrize("mode", worker.MODES)
def test_losses_match_the_jax_sharded_step(runs, mode):
    for rank in _ranks(runs, mode):  # every rank holds the global batch's losses
        for i, (got, ref) in enumerate(zip(rank["losses"], runs["ref"])):
            assert sorted(got) == sorted(ref["losses"])
            for k, v in got.items():
                np.testing.assert_allclose(v, ref["losses"][k], rtol=1e-4 if i < 2 else 2e-4,
                                           err_msg=f"{mode} step {i + 1} {k}")


@pytest.mark.parametrize("mode", worker.MODES)
def test_state_follows_the_jax_sharded_step(runs, mode):
    t, ref, before = runs["tensors"][mode], runs["ref"], runs["initial"]
    for i in range(2):  # statistics of forwards through the first parameters
        for k, v in t["stats"][i].items():
            np.testing.assert_allclose(v.numpy(), ref[i]["state"][k], atol=1e-5, rtol=1e-5, err_msg=f"{i} {k}")
    after = {k: v.numpy() for k, v in t["updated"].items()}
    delta = lambda sd: {k: sd[k] - before[k] for k in before}
    rel = _rel_rms_by_group(delta(after), delta(ref[1]["state"]))
    assert max(rel.values()) <= 1e-2, rel
    for k in runs["params"]:
        np.testing.assert_allclose(after[k], ref[1]["state"][k], atol=2 * LR, rtol=0, err_msg=k)


@pytest.mark.parametrize("mode", worker.MODES)
def test_ranks_compute_the_one_process_step_at_the_global_batch(runs, mode):
    one, t = runs["one"], runs["tensors"][mode]
    losses = _ranks(runs, mode)[0]["losses"]
    for i in range(2):  # before the update: fp32 reduction order only
        for k, v in losses[i].items():
            np.testing.assert_allclose(v, one["losses"][i][k], rtol=1e-5, err_msg=f"step {i + 1} {k}")
    for k, v in losses[2].items():
        np.testing.assert_allclose(v, one["losses"][2][k], rtol=1e-4, err_msg=f"step 3 {k}")
    got = {k: v.numpy() for k, v in t["grads"].items()}
    ref = {k: v.numpy() for k, v in one["grads"].items()}
    rel = _rel_rms_by_group(got, ref)
    assert max(rel.values()) <= 1e-3, rel
    for k, v in t["stats"][0].items():
        np.testing.assert_allclose(v.numpy(), one["stats"][0][k].numpy(), atol=1e-5, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("mode", worker.MODES)
def test_replicated_leaves_are_bitwise_across_ranks_and_shards_are_parts(runs, mode):
    ranks = _ranks(runs, mode)
    assert ranks[0]["replicated"] and all(r["replicated"] == ranks[0]["replicated"] for r in ranks)
    if mode == "ddp":
        assert ranks[0]["split"] == {}
        return
    assert ranks[0]["split"] and all(r["split"] == ranks[0]["split"] for r in ranks)
    for name, (shard, full, parts) in ranks[0]["split"].items():
        assert np.prod(shard) * parts == np.prod(full), name
    if mode == "tp":
        assert any("attn.qkv" in n for n in ranks[0]["split"]) and any("affine_regressor.fc1" in n
                                                                       for n in ranks[0]["split"])
    if mode == "fsdp":
        ddp = sum(_ranks(runs, "ddp")[0]["held"].values())
        assert sum(ranks[0]["held"].values()) <= 0.6 * ddp, (ranks[0]["held"], _ranks(runs, "ddp")[0]["held"])


@pytest.mark.parametrize("mode", worker.MODES)
def test_each_rank_trains_on_its_rows_of_the_global_batch(runs, mode):
    for rank in _ranks(runs, mode):
        d, _ = rank["coords"]
        n = len(rank["rows"])
        np.testing.assert_array_equal(rank["rows"], runs["batch"]["real_pose"][d * n:(d + 1) * n])
    assert sum(len(r["rows"]) for r in _ranks(runs, mode) if r["coords"][1] == 0) == B


def test_broadcast_and_barrier(runs):
    for (world, _), ranks in runs["groups"].items():
        assert [r["broadcast"] for r in ranks] == [{"from": 0, "world": world}] * world


@pytest.mark.parametrize("world", list(worker.WORLDS))
def test_rank0_checkpoint_is_the_one_device_file_and_restores_at_world_1_and_n(runs, world):
    plan = worker.WORLDS[world]
    path = runs["worlds"][world][0][plan["runs"][0][0]]["ckpt"]
    got = torch.load(path, weights_only=True)
    one = torch.load(runs["one"]["ckpt"], weights_only=True)
    assert got.keys() == one.keys()
    assert (got["step"], got["epoch"], got["mini_step"], got["scheduler"]) == \
           (one["step"], one["epoch"], one["mini_step"], one["scheduler"]) == (3, 0, 1, {"last_epoch": 1})
    assert got["model"].keys() == one["model"].keys()
    assert all(got["model"][k].shape == one["model"][k].shape for k in one["model"])
    for k in runs["params"]:
        np.testing.assert_allclose(got["model"][k].numpy(), one["model"][k].numpy(), atol=2 * LR, rtol=0, err_msg=k)
    assert got["optimizer"]["state"].keys() == one["optimizer"]["state"].keys()
    assert [g.shape for g in got["grads"]] == [g.shape for g in one["grads"]]
    for rank in runs["worlds"][world]:  # into other layouts at this world size
        assert rank["restored"] == {m: dict(model=True, moments=True, grads=True, counters=True)
                                    for m, _, _ in plan["restore"]}

    state = worker.fresh_state(runs["work"])  # world size 1
    ckpt.restore(os.path.dirname(os.path.dirname(path)), None, state)
    assert all(torch.equal(v, got["model"][k]) for k, v in state.model.state_dict().items())
    assert all(torch.equal(a, b) for a, b in zip(state.optimizer.grads, got["grads"]))
    assert (state.step, state.optimizer.updates, state.optimizer.mini_step) == (3, 1, 1)


@pytest.mark.parametrize("world,mode", [(w, m) for w, layouts in worker.ORBAX_LAYOUTS.items() for m, _, _ in layouts])
def test_a_jax_run_resumes_over_ranks_as_its_one_process_restore(runs, world, mode):
    """Each rank's shards, buffers, moments, gradients and counters
    restored from either orbax fixture are bitwise its part of the
    one-process restore (the ``.pt`` file restored in this layout), and
    the step from the two processes' save is bitwise the step from the
    ``.pt``; that save is decoded in part under a split layout."""
    for rank in runs["orbax"][world]:
        ref = rank[mode, worker.PT]
        assert ref["before"]["counters"] == repr((5, 2, 2, 1))  # step 5, mid-accumulation
        assert ref["after"]["counters"] == repr((6, 3, 3, 0))  # the step completed it and updated
        changed = [k for k in ref["before"] if k.startswith("model.") and ref["after"][k] != ref["before"][k]]
        assert any(".weight" in k for k in changed)
        for source in worker.ORBAX:
            got = rank[mode, source]
            differ = [k for k in ref["before"] if got["before"][k] != ref["before"][k]]
            assert not differ, (source, differ[:5])
        got = rank[mode, "orbax_sharded"]
        assert got["losses"] == ref["losses"] and got["after"] == ref["after"]
        whole, part = rank[mode, "orbax_small"]["decoded"], rank[mode, "orbax_sharded"]["decoded"]
        if mode in ("fsdp", "fsdp_tp"):
            assert part < 0.6 * whole, (part, whole)


# ---------------------------------------------------------------- the training CLI over two ranks


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's, emptied when the test ends (the CLI runs write ~1.6 GB)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)



def _cli_args(tree, bs, n_devices):
    return ["--device", "cpu", "--config", os.path.join(ROOT, "configs", "base.yaml"), "--max_steps", "2",
            "--set", f"train_dataset.data_dir={tree}", "train_dataset.min_px_count_visib=100",
            "trainer.training_epoch=1", "lr_scheduler.max_iters=2", "trainer.iters_to_print=1",
            f"train_dataloader.bs={bs}", "train_dataloader.num_workers=1", "train_dataloader.backend=threads",
            f"trainer.n_devices={n_devices}", "model.vit_type=vit_tiny_test", "model.blocks_to_take=[0,1,2,3]",
            "model.compute_dtype=float32"]


def test_run_train_over_two_ranks_follows_one_process(tmp_path):
    tree = write_megapose_tree(str(tmp_path / "mp"))
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    two = tmp_path / "two"
    two.mkdir()
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1", "--nproc_per_node", "2",
         "--master_addr", "localhost", "--master_port", str(free_port()),
         "-m", "picopose_tpu_torch.run_train", "--dist_backend", "gloo", *_cli_args(tree, 1, 2)],
        cwd=two, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        cfg = load_config(os.path.join(ROOT, "configs", "base.yaml"), _cli_args(tree, 2, 1)[7:])
        T.run_training(cfg, str(tmp_path / "one"), max_steps=2, device="cpu")
    finally:
        out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    assert "process (0, 2)" in out and "process (1, 2)" in out
    got = torch.load(two / "log" / "picopose" / "version_0" / "checkpoints" / "2.pt", weights_only=True)
    ref = torch.load(tmp_path / "one" / "checkpoints" / "2.pt", weights_only=True)
    assert got["model"].keys() == ref["model"].keys() and got["step"] == ref["step"] == 2
    lr = cfg.optimizer.lr
    for k, v in ref["model"].items():
        tol = dict(atol=1e-5, rtol=1e-5) if "running" in k else dict(atol=2 * 2 * lr, rtol=0)
        np.testing.assert_allclose(got["model"][k].numpy(), v.numpy(), err_msg=k, **tol)
    log = (two / "log" / "picopose" / "version_0" / "training_logger.log").read_text().splitlines()
    assert [line.split("] ")[1].split(" |")[0] for line in log] == ["iter 1", "iter 2", "epoch 0 done at iter 2"]
