"""The port's training loop pieces (picopose_tpu_torch/train/loop.py,
utils/logging.py) against the JAX package's (picopose_tpu/train/loop.py,
utils/logging.py), on the small MegaPose tree of
tests/torch_bop_tree.py::write_megapose_tree.

Tolerances: batches bitwise (``PICOPOSE_NO_FASTPATH=1`` keeps the JAX
package's crops on its cv2 path, in its worker processes too); log lines
equal as text once the time stamps are cut.  The loop's quirks (epoch
counter, noise seed, warm start, logged lr, checkpoint cadence, one
device) are held with the step replaced by a stand-in that only counts,
since they are the loop's and not the step's; tests/test_torch_train_
checkpoint.py runs real steps.
"""

import logging
import os
import types

import numpy as np
import pytest
import torch
from torch_bop_tree import write_megapose_tree

from picopose_tpu.data.megapose import MegaPoseTrainingDataset as JDataset
from picopose_tpu.train import loop as J
from picopose_tpu.utils import logging as JL
from picopose_tpu_torch.data.megapose import MegaPoseTrainingDataset
from picopose_tpu_torch.train import loop as T
from picopose_tpu_torch.utils import logging as TL
from picopose_tpu_torch.utils.config import load_config
from picopose_tpu_torch.utils.graphs import GraphCache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_megapose_tree(str(tmp_path_factory.mktemp("mp")))


@pytest.fixture
def cv2_crops(monkeypatch):
    monkeypatch.setenv("PICOPOSE_NO_FASTPATH", "1")


def _kw(tree, augment_real=True):
    return dict(data_dir=tree, min_px_count_visib=100, augment_real=augment_real)


def _assert_batches_equal(got, ref):
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"batch {i} {k}")


def test_mp_prefetch_matches_jax_and_itself(tree, cv2_crops):
    """Two workers against the JAX package's two, and against one worker:
    each batch is reseeded from (seed, epoch, start)."""
    args = dict(batch_size=2, steps=3, seed=7, epoch=1)
    two = list(T.mp_prefetch_batches(_kw(tree), workers=2, **args))
    _assert_batches_equal(two, list(J.mp_prefetch_batches(_kw(tree), workers=2, **args)))
    _assert_batches_equal(list(T.mp_prefetch_batches(_kw(tree), workers=1, **args)), two)
    assert two[0]["real_rgb"].shape == (2, 224, 224, 3)


def test_workers_start_single_threaded(monkeypatch):
    """Processes the loader starts inherit one thread per numeric library;
    a value the caller set is kept, and the parent's environment is
    restored."""
    monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    monkeypatch.delenv("MKL_NUM_THREADS", raising=False)
    monkeypatch.setenv("OPENBLAS_NUM_THREADS", "3")
    with T._single_threaded_children():
        assert os.environ["OMP_NUM_THREADS"] == os.environ["MKL_NUM_THREADS"] == "1"
        assert os.environ["OPENBLAS_NUM_THREADS"] == "3"
    assert "OMP_NUM_THREADS" not in os.environ and "MKL_NUM_THREADS" not in os.environ
    assert os.environ["OPENBLAS_NUM_THREADS"] == "3"


def test_a_worker_exception_surfaces(tmp_path):
    """A dataset with no samples fails in the worker (index % 0); the
    exception reaches the consumer."""
    with pytest.raises(ZeroDivisionError):
        list(T.mp_prefetch_batches(dict(data_dir=str(tmp_path)), 2, steps=2, workers=1))


def test_prefetch_batches_one_worker_matches_jax(tree, cv2_crops):
    port = MegaPoseTrainingDataset(seed=4, **_kw(tree))
    jax = JDataset(seed=4, **_kw(tree))
    got = list(T.prefetch_batches(port, 2, steps=4, workers=1))
    _assert_batches_equal(got, list(J.prefetch_batches(jax, 2, steps=4, workers=1)))
    assert port.rng.bit_generator.state == jax.rng.bit_generator.state


def test_thread_pool_shares_the_dataset_generator(tree):
    """With more than one thread every sample draws from the dataset's one
    generator (so the order of the draws, and the stream, follow the
    threads' timing; the JAX package's behaviour)."""
    ds = MegaPoseTrainingDataset(seed=4, **_kw(tree))
    before = ds.rng.bit_generator.state
    batches = list(T.prefetch_batches(ds, 2, steps=2, workers=2))
    assert len(batches) == 2 and ds.rng.bit_generator.state != before


def test_prefetch_batches_surfaces_a_loader_exception(tree):
    ds = MegaPoseTrainingDataset(seed=4, **_kw(tree))

    def broken(i):
        raise RuntimeError(f"loader boom {i}")

    ds.get = broken
    with pytest.raises(RuntimeError, match="loader boom"):
        list(T.prefetch_batches(ds, 2, steps=3, workers=1))


def test_device_prefetch_keeps_order_and_surfaces_errors():
    """tests/test_integration_io.py::TestDevicePrefetch on the CPU, where
    batches pass as they are."""
    batches = [{"a": np.full((4, 8), i, np.float32)} for i in range(5)]
    out = list(T.device_prefetch(iter(batches), "cpu"))
    assert [float(b["a"][0, 0]) for b in out] == [0.0, 1.0, 2.0, 3.0, 4.0]

    def bad():
        yield {"a": np.ones((2, 2), np.float32)}
        raise RuntimeError("producer boom")

    with pytest.raises(RuntimeError, match="producer boom"):
        list(T.device_prefetch(bad(), "cpu"))


def _log_lines(path):
    with open(path) as f:
        return [line.split("] ", 1)[1].rstrip("\n") for line in f]


def test_logger_lines_match_jax(tmp_path, monkeypatch):
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    steps = [{k: np.float32(rng.uniform(0, 5)) for k in ("loss", "loss_info", "loss_flow0")} for _ in range(7)]
    loggers = {}
    for name, module, tensor in (("port", TL, torch.tensor), ("jax", JL, jnp.asarray)):
        clock = iter(np.arange(1000.0) * 0.37)  # the same clock readings for both
        monkeypatch.setattr(module, "time", types.SimpleNamespace(time=lambda c=clock: float(next(c))))
        logger = loggers[name] = module.TrainLogger(str(tmp_path / name), every=3, tensorboard=False)
        for i, s in enumerate(steps, start=1):
            logger.step_async(i, {k: tensor(v) for k, v in s.items()}, 1e-5 * i)
        logger.epoch(0, 7)
    port, jax = loggers["port"], loggers["jax"]
    for h in port.logger.handlers + jax.logger.handlers:
        h.flush()
    got = _log_lines(tmp_path / "port" / "training_logger.log")
    assert got == _log_lines(tmp_path / "jax" / "training_logger.log")
    assert [line.split(" |")[0] for line in got] == ["iter 3", "iter 6", "epoch 0 done at iter 7"]
    assert TL.get_logger(str(tmp_path / "port")) is port.logger  # one logger per directory
    logging.getLogger(port.logger.name).handlers.clear()


def test_logger_reads_back_only_at_print_boundaries(tmp_path):
    logger = TL.TrainLogger(str(tmp_path), every=4, tensorboard=False)
    for i in range(1, 4):
        logger.step_async(i, {"loss": torch.tensor(float(i))}, 1e-5)
        assert len(logger._pending) == i and not logger.meter.counts  # nothing read yet
    logger.step_async(4, {"loss": torch.tensor(4.0)}, 1e-5)
    assert not logger._pending and logger.meter.counts["loss"] == 4
    logger.step_async(5, {"loss": torch.tensor(5.0)}, 1e-5)
    logger.epoch(0, 5)
    assert not logger._pending and logger.meter.global_avg("loss") == 3.0


# ---------------------------------------------------------------- the loop


def _cfg(tree, *overrides):
    return load_config(os.path.join(ROOT, "configs", "base.yaml"), [
        f"train_dataset.data_dir={tree}", "train_dataset.min_px_count_visib=100", "trainer.training_epoch=3",
        "lr_scheduler.max_iters=6", "lr_scheduler.warmup_iters=2", "trainer.iters_to_print=1",
        "train_dataloader.bs=1", "train_dataloader.num_workers=1", "train_dataloader.backend=threads",
        "model.vit_type=vit_tiny_test", "model.blocks_to_take=[0,1,2,3]", "model.compute_dtype=float32",
        *overrides,
    ])


class _Steps:
    """Stands in for the compiled step: counts, records the noise
    generator's seed and the batch size, and returns fixed losses."""

    def __init__(self):
        self.seeds, self.sizes = [], []
        self.graphs = GraphCache("cpu")

    def __call__(self, state, batch, noise):
        self.seeds.append(noise.initial_seed())
        self.sizes.append(len(batch["real_rgb"]))
        state.step += 1
        return {"loss": torch.tensor(float(state.step))}


@pytest.fixture
def light_loop(monkeypatch):
    """The loop with the stand-in step, and saves that record their
    (step, epoch) in small files."""
    steps = _Steps()
    saves = []

    def save(log_dir, step, state, epoch):
        saves.append((step, epoch))
        path = T.ckpt.checkpoint_path(log_dir, step)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save({"step": step}, path)

    def restore(log_dir, step, state):
        state.step = torch.load(T.ckpt.checkpoint_path(log_dir, T.ckpt.latest_step(log_dir)))["step"]
        return state

    monkeypatch.setattr(T, "make_train_step", lambda state: steps)
    monkeypatch.setattr(T.ckpt, "save", save)
    monkeypatch.setattr(T.ckpt, "restore", restore)
    return steps, saves


def test_loop_epochs_checkpoints_and_resume(tree, tmp_path, light_loop):
    """2 epochs of 2 steps saved at 2 and 4; on resume the epoch counter
    restarts at 0, runs min(iters_per_epoch, total - step) steps and saves
    at the end; the noise generator is seeded rd_seed + 1 both times."""
    steps, saves = light_loop
    log = str(tmp_path / "log")
    T.run_training(_cfg(tree), log, max_steps=4, device="cpu")
    assert saves == [(2, 0), (4, 1)] and steps.sizes == [1] * 4
    T.run_training(_cfg(tree), log, resume=True, max_steps=6, device="cpu")
    assert saves[2:] == [(6, 0)]
    assert set(steps.seeds) == {1}  # rd_seed 0 + 1, also when resuming
    lines = _log_lines(os.path.join(log, "training_logger.log"))
    assert [line.split(" |")[0] for line in lines] == [
        "iter 1", "iter 2", "epoch 0 done at iter 2", "iter 3", "iter 4", "epoch 1 done at iter 4",
        "iter 5", "iter 6", "epoch 0 done at iter 6"]
    # a run that has reached its total runs nothing more
    T.run_training(_cfg(tree), log, resume=True, max_steps=6, device="cpu")
    assert len(steps.seeds) == 6 and len(saves) == 3


def test_checkpoint_cadence(tree, tmp_path, light_loop):
    """ckpt_every_epochs 2 over 3 epochs: epoch 1 and the last one."""
    _, saves = light_loop
    T.run_training(_cfg(tree, "trainer.ckpt_every_epochs=2"), str(tmp_path), device="cpu")
    assert saves == [(4, 1), (6, 2)]


def test_logged_lr_follows_grad_accum(tree, tmp_path, light_loop):
    cfg = _cfg(tree, "trainer.grad_accum=2")
    T.run_training(cfg, str(tmp_path), max_steps=4, device="cpu")
    sched = T.warmup_cosine_schedule(cfg.optimizer.lr, 6, 2, cfg.lr_scheduler.warmup_factor)
    lrs = [line.split(" | ")[1] for line in _log_lines(tmp_path / "training_logger.log") if line.startswith("iter")]
    assert lrs == [f"lr {sched(step // 2):.3e}" for step in range(1, 5)]


def test_warm_start_is_skipped_only_when_resuming_finds_a_checkpoint(tree, tmp_path, light_loop, monkeypatch):
    calls = []
    monkeypatch.setattr(T, "warm_start", lambda state, path, num_levels=3: calls.append(path))
    cfg = _cfg(tree, "trainer.init_checkpoint=/weights.pth")
    T.run_training(cfg, str(tmp_path), resume=True, max_steps=2, device="cpu")  # nothing to resume from
    assert calls == ["/weights.pth"]
    T.run_training(cfg, str(tmp_path), resume=True, max_steps=4, device="cpu")
    assert calls == ["/weights.pth"]
    T.run_training(cfg, str(tmp_path), max_steps=2, device="cpu")  # not resuming
    assert calls == ["/weights.pth"] * 2


@pytest.mark.parametrize("override, error, match", [
    ("trainer.n_devices=2", ValueError, "process group has 1 rank"),
    ("trainer.n_model=2", ValueError, "n_model 2 does not divide"),
    ("trainer.parallel=zero9", ValueError, "zero9"),
    ("model.num_levels=4", ValueError, "DPT head"),
    ("train_dataloader.backend=gpu", ValueError, "gpu"),
])
def test_settings_the_port_does_not_run_raise(tree, tmp_path, light_loop, override, error, match):
    with pytest.raises(error, match=match):
        T.run_training(_cfg(tree, override), str(tmp_path), max_steps=1, device="cpu")


@pytest.mark.parametrize("parallel", ["ddp", "fsdp", "tp", "fsdp_tp"])
def test_every_parallel_mode_runs_at_one_device(tree, tmp_path, light_loop, parallel):
    steps, _ = light_loop
    T.run_training(_cfg(tree, f"trainer.parallel={parallel}", "trainer.n_devices=-1"), str(tmp_path),
                   max_steps=1, device="cpu")
    assert len(steps.seeds) == 1


def test_training_needs_a_card_unless_cpu_is_asked(tree, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.run_training(_cfg(tree), str(tmp_path), max_steps=1, device=device)
