"""The training loop: loading, upload, steps, logging, checkpoints, resume.

Counterpart of picopose_tpu/train/loop.py on one device (the reference's
run_train.py:49-131 and the Lightning behaviour it relies on: the dataset
reset at each epoch start, the per-step learning-rate schedule, one
checkpoint per epoch with every one kept, resume):

  * ``prefetch_batches``: a thread pool fills a bounded queue of collated
    batches (:33-74);
  * ``mp_prefetch_batches``: a ``spawn`` process pool, each worker with its
    own dataset, each batch reseeded from (seed, epoch, start) so the
    stream is the same whichever worker builds it (:114-192).  Workers
    import the data modules only as far as numpy and torch and never
    initialise CUDA;
  * ``device_prefetch``: uploads ``depth`` batches ahead (:77-111).  On the
    card a thread pins each batch in host memory and copies it on a side
    stream, holding the compiled step's lock around those CUDA calls (a
    capture refuses another thread's); the consumer's stream waits on the
    copy's event and each tensor is recorded on that stream.  On the CPU
    batches pass as they are;
  * ``warm_start``: model weights from a checkpoint file (:195-298): a full
    PicoPose checkpoint (the reference's Lightning ``.ckpt``, a raw ``Net``
    state dict ``.pth`` or a train state of utils/checkpoint.py) fills
    every parameter and BatchNorm statistic; torch-hub DINOv2 backbone
    weights (``.pth``), the reference's ``pretrained: True``, fill the ViT
    only.  The step counter and the optimizer stay as they are; a layout
    or shape mismatch raises;
  * ``run_training`` (:301-420): every step through the compiled step
    (train/step.py::make_train_step), made once, as the JAX loop jits its
    step once (:350).

A producer's exception (a loader thread, a worker process, the uploader)
is raised in the training loop.  The JAX loop's quirks are kept: on
resume the epoch counter restarts at 0 and each epoch runs
``min(iters_per_epoch, total - step)`` steps; the stage-3 noise generator
is seeded with ``rd_seed + 1`` whether or not the run resumes; the warm
start is skipped only when resuming finds a checkpoint; the logged lr is
``sched(step // grad_accum)``; a thread pool of more than one worker
shares the dataset's generator, so its stream is not reproducible.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import multiprocessing as mp
import os
import queue
import threading
from typing import Iterator, Mapping

import numpy as np
import torch

from picopose_tpu_torch.data.megapose import MegaPoseTrainingDataset, collate
from picopose_tpu_torch.device import resolve_device
from picopose_tpu_torch.models.picopose import model_kwargs
from picopose_tpu_torch.train.step import init_state, make_optimizer, make_train_step, warmup_cosine_schedule
from picopose_tpu_torch.utils import checkpoint as ckpt
from picopose_tpu_torch.utils.checkpoint import read_weights
from picopose_tpu_torch.utils.logging import TrainLogger
from picopose_tpu_torch.utils.torch_port import port_dinov2, port_picopose, to_numpy_state_dict
from picopose_tpu_torch.utils.weights import _dinov2, state_dict_from_flax

_PARALLEL_MODES = ("ddp", "fsdp", "tp", "fsdp_tp")


def _put(q: queue.Queue, item, stop: threading.Event) -> bool:
    """Put ``item`` unless ``stop`` is set first; returns whether it went in."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            pass
    return False


def _drain(q: queue.Queue, stop: threading.Event) -> Iterator:
    """Yield what producers put until their None; raise what they raised."""
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def prefetch_batches(
    dataset: MegaPoseTrainingDataset,
    batch_size: int,
    steps: int,
    workers: int = 10,
    depth: int = 2,
) -> Iterator[dict[str, np.ndarray]]:
    """Threaded batch producer with a bounded queue."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    # retries draw from the dataset's own generator, so with one worker the
    # whole epoch's stream is reproducible (the reference keeps retries in
    # the seeded Dataset too, training_dataset.py:126-135)
    rng = dataset.rng

    def produce():
        try:
            with cf.ThreadPoolExecutor(workers) as pool:
                idx = 0
                for _ in range(steps):
                    if stop.is_set():
                        return
                    futs = [pool.submit(dataset.get, idx + j) for j in range(batch_size)]
                    idx += batch_size
                    samples = [s for s in (f.result() for f in futs) if s is not None]
                    while len(samples) < batch_size:  # extremely rare
                        s = dataset.get(int(rng.integers(1 << 30)))
                        if s is not None:
                            samples.append(s)
                    if not _put(q, collate(samples), stop):
                        return
            _put(q, None, stop)
        except BaseException as e:  # raised in the consumer
            _put(q, e, stop)

    threading.Thread(target=produce, daemon=True).start()
    yield from _drain(q, stop)


# a worker process's dataset and the (seed, epoch) its batches are drawn from
_W_DS = None
_W_SEED = 0
_W_EPOCH = 0


def _mp_init(ds_kwargs: dict, seed: int, epoch: int):
    """Worker initializer: build a private dataset whose epoch subset matches
    every other worker's (its generator seeded by (seed, epoch) for reset)."""
    global _W_DS, _W_SEED, _W_EPOCH
    _W_DS = MegaPoseTrainingDataset(seed=seed, **ds_kwargs)
    _W_DS.rng = np.random.default_rng([seed, epoch])
    _W_DS.reset()
    _W_SEED, _W_EPOCH = seed, epoch


def _mp_batch(args: tuple[int, int]) -> dict[str, np.ndarray]:
    """One collated batch, built in the worker and sent back in one
    pickle.  The per-sample draws (instance, augmentation, retries,
    template view) are reseeded from (seed, epoch, start): batch ``start``
    is the same whichever worker builds it, in whatever order."""
    start, bs = args
    _W_DS.rng = np.random.default_rng([_W_SEED, _W_EPOCH, start])
    samples = []
    for j in range(bs):
        s = _W_DS.get(start + j)
        if s is not None:
            samples.append(s)
    while len(samples) < bs:  # extremely rare
        s = _W_DS.get(int(_W_DS.rng.integers(1 << 30)))
        if s is not None:
            samples.append(s)
    return collate(samples)


# thread pools of the numeric libraries, one per process unless set: ten
# workers with a BLAS pool per core each thrash an 8-core host
_WORKER_THREADS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


@contextlib.contextmanager
def _single_threaded_children():
    """Processes started inside inherit one thread per numeric library
    (variables the caller set are kept); the parent's libraries, already
    loaded, are not affected."""
    unset = [k for k in _WORKER_THREADS if k not in os.environ]
    os.environ.update({k: "1" for k in unset})
    try:
        yield
    finally:
        for k in unset:
            os.environ.pop(k, None)


def mp_prefetch_batches(
    ds_kwargs: dict,
    batch_size: int,
    steps: int,
    workers: int = 10,
    depth: int = 2,
    seed: int = 0,
    epoch: int = 0,
) -> Iterator[dict[str, np.ndarray]]:
    """Process-pool batch producer: each worker owns a dataset replica and
    sends whole collated batches, in order; up to ``workers + depth`` are in
    flight.  ``ds_kwargs``: MegaPoseTrainingDataset's arguments but
    ``seed``.  The pool starts workers with ``spawn``: the trainer holds a
    CUDA context by the first epoch, and a forked one is unusable.  Each
    worker runs its numeric libraries on one thread."""
    with cf.ProcessPoolExecutor(
        workers, mp_context=mp.get_context("spawn"),
        initializer=_mp_init, initargs=(ds_kwargs, seed, epoch),
    ) as pool:
        inflight: list = []
        nxt = 0
        with _single_threaded_children():  # a spawn pool starts a worker per submit, up to ``workers``
            for _ in range(min(steps, workers + depth)):
                inflight.append(pool.submit(_mp_batch, (nxt, batch_size)))
                nxt += batch_size
        try:
            for done in range(steps):
                fut = inflight.pop(0)
                if done + len(inflight) + 1 < steps:
                    inflight.append(pool.submit(_mp_batch, (nxt, batch_size)))
                    nxt += batch_size
                yield fut.result()
        finally:
            for fut in inflight:
                fut.cancel()


def device_prefetch(
    batches: Iterator[Mapping[str, np.ndarray]], device: str | torch.device, depth: int = 2,
    lock: threading.Lock | None = None,
) -> Iterator[Mapping]:
    """Upload ``batches`` to ``device`` up to ``depth`` ahead of the
    consumer (module docstring), holding ``lock`` (when given) around each
    batch's CUDA calls; on the CPU they pass as they are."""
    device = torch.device(device)
    if device.type != "cuda":
        yield from batches
        return
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def produce():
        try:
            with torch.cuda.device(device):
                stream = torch.cuda.Stream()
                for b in batches:
                    with lock or contextlib.nullcontext(), torch.cuda.stream(stream):
                        # a fresh pinned buffer per batch: the caching host
                        # allocator reuses it only after its copy has run
                        host = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory() for k, v in b.items()}
                        dev = {k: v.to(device, non_blocking=True) for k, v in host.items()}
                        copied = torch.cuda.Event()
                        copied.record(stream)
                    if not _put(q, (dev, copied), stop):
                        return
            _put(q, None, stop)
        except BaseException as e:  # raised in the consumer
            _put(q, e, stop)
        finally:
            close = getattr(batches, "close", None)
            if close is not None:
                close()  # shuts a worker pool down

    uploader = threading.Thread(target=produce, daemon=True)
    uploader.start()
    try:
        for dev, copied in _drain(q, stop):
            current = torch.cuda.current_stream(device)
            current.wait_event(copied)
            for v in dev.values():
                v.record_stream(current)  # the allocator must not hand these back to the side stream early
            yield dev
    finally:
        stop.set()
        uploader.join()  # the batches' worker pool is shut down with it


@torch.no_grad()
def _graft(model: torch.nn.Module, new: Mapping[str, np.ndarray], what: str, subset: bool = False) -> None:
    """Copy ``new`` (the port's state-dict keys, numpy values) into
    ``model`` in place, cast to each entry's dtype.  With ``subset=False``
    every entry of the model's state must be covered; with ``subset=True``
    only the keys present are replaced.  Raises ValueError on unknown keys
    or shape mismatches, before anything is copied."""
    state = model.state_dict()
    extra = [k for k in new if k not in state]
    missing = [] if subset else [k for k in state if k not in new]
    if missing or extra:
        raise ValueError(
            f"{what}: checkpoint layout mismatch (missing {missing[:3]}{'…' if len(missing) > 3 else ''}, "
            f"unexpected {extra[:3]}{'…' if len(extra) > 3 else ''})"
        )
    for k, v in new.items():
        if tuple(np.shape(v)) != tuple(state[k].shape):
            raise ValueError(
                f"{what}: shape mismatch at {k}: checkpoint {tuple(np.shape(v))} vs model {tuple(state[k].shape)}"
            )
    for k, v in new.items():
        state[k].copy_(torch.from_numpy(np.ascontiguousarray(v)))


def warm_start(state, path: str, num_levels: int = 3):
    """Fill ``state.model``'s weights from the checkpoint at ``path`` (see
    the module docstring) and return ``state``."""
    model = state.model
    depth = len(model.feature_extractor.dinov2.blocks)
    raw = read_weights(path)
    sd = raw.get("state_dict", raw) if isinstance(raw, dict) else raw
    keys = [str(k) for k in sd]
    if any(k.startswith(("network.", "feature_extractor.")) for k in keys):
        variables = port_picopose(raw, depth=depth, num_levels=num_levels)
        _graft(model, state_dict_from_flax(variables), "warm_start")
    elif any(k.startswith("patch_embed.proj.") for k in keys):
        try:
            vit = port_dinov2(to_numpy_state_dict(sd), depth, strict=True)["dinov2"]
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
        new: dict[str, np.ndarray] = {}
        _dinov2(new, vit, "feature_extractor.dinov2.")
        _graft(model, new, "warm_start params", subset=True)
    else:
        raise ValueError(
            f"{path}: neither a PicoPose checkpoint nor DINOv2 backbone weights (no recognizable keys)"
        )
    return state


def _one_device(cfg, device: torch.device) -> None:
    """The port trains on one device (ROADMAP A.8); at one device every
    ``trainer.parallel`` mode computes the same step, as the JAX package
    shards nothing on a mesh of one."""
    t = cfg.trainer
    n_dev = t.n_devices
    if n_dev == -1:
        n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    if n_dev != 1 or t.n_model != 1:
        raise NotImplementedError(
            f"trainer.n_devices {t.n_devices} (resolves to {n_dev}) and trainer.n_model {t.n_model}: "
            "the port trains on one device; multi-GPU training is ROADMAP A.8"
        )
    if t.parallel not in _PARALLEL_MODES:
        raise ValueError(f"unknown trainer.parallel {t.parallel!r}; one of {_PARALLEL_MODES}")


def run_training(
    cfg,
    log_dir: str,
    resume: bool = False,
    max_steps: int | None = None,
    device: str | torch.device | None = None,
) -> None:
    """Train PicoPose as ``cfg`` says (utils/config.py::Config) on one
    device (CUDA unless "cpu" is passed; raises without a card), logging
    to and checkpointing under ``log_dir``; ``resume`` continues from the
    latest checkpoint there; ``max_steps`` stops early."""
    device = resolve_device(device)
    _one_device(cfg, device)
    model_kw = dict(model_kwargs(cfg), remat_vit=cfg.model.remat_vit)
    t = cfg.trainer
    tx = make_optimizer(
        base_lr=cfg.optimizer.lr,
        max_iters=cfg.lr_scheduler.max_iters,
        warmup_iters=cfg.lr_scheduler.warmup_iters,
        warmup_factor=cfg.lr_scheduler.warmup_factor,
        betas=tuple(cfg.optimizer.betas),
        eps=cfg.optimizer.eps,
        weight_decay=cfg.optimizer.weight_decay,
        opt_type=cfg.optimizer.type,
        schedule_type=cfg.lr_scheduler.type,
        grad_accum=t.grad_accum,
    )
    # the logged lr is the warmup-cosine one whatever the schedule, as in the JAX loop
    sched = warmup_cosine_schedule(
        cfg.optimizer.lr, cfg.lr_scheduler.max_iters, cfg.lr_scheduler.warmup_iters, cfg.lr_scheduler.warmup_factor,
    )
    state = init_state(tx, t.rd_seed, device=device, **model_kw)
    resuming = resume and ckpt.latest_step(log_dir) is not None
    # weight warm start (trainer.init_checkpoint), skipped when resuming:
    # the restore below replaces everything anyway
    if t.init_checkpoint and not resuming:
        warm_start(state, str(t.init_checkpoint), num_levels=cfg.model.num_levels)
        print(f"warm-started model weights from {t.init_checkpoint}")
    train_step = make_train_step(state)
    if resuming:
        ckpt.restore(log_dir, None, state)
        print(f"resumed from step {state.step}")

    d = cfg.train_dataset
    ds_kwargs = dict(
        data_dir=d.data_dir, img_size=d.img_size, min_visib_fract=d.min_visib_fract,
        min_px_count_visib=d.min_px_count_visib, augment_real=d.augment_real, rgb_mask_flag=d.rgb_mask_flag,
    )
    dataset = MegaPoseTrainingDataset(seed=t.rd_seed, **ds_kwargs)
    loader = cfg.train_dataloader
    backend = loader.backend
    if backend == "auto":  # processes where the host has the cores for them
        backend = "procs" if (os.cpu_count() or 1) >= 8 else "threads"
    if backend not in ("procs", "threads"):
        raise ValueError(f"unknown train_dataloader.backend {loader.backend!r}")

    bs = loader.bs
    iters_per_epoch = cfg.lr_scheduler.max_iters // t.training_epoch
    logger = TrainLogger(log_dir, every=t.iters_to_print)
    noise = torch.Generator(device=device).manual_seed(t.rd_seed + 1)  # registered with the step's graphs

    step = state.step
    total = max_steps or cfg.lr_scheduler.max_iters
    for epoch in range(t.training_epoch):
        if step >= total:
            break
        dataset.reset()  # epoch resampling (utils/lite.py:29-31)
        n_steps = min(iters_per_epoch, total - step)
        if backend == "procs":
            batches = mp_prefetch_batches(ds_kwargs, bs, steps=n_steps, workers=loader.num_workers,
                                          seed=t.rd_seed, epoch=epoch)
        else:
            batches = prefetch_batches(dataset, bs, steps=n_steps, workers=loader.num_workers)
        for batch in device_prefetch(batches, device, lock=train_step.graphs.lock):
            losses = train_step(state, batch, noise)
            step += 1
            # no host sync until the print boundary; with grad_accum the
            # schedule advances once per optimizer update
            logger.step_async(step, losses, sched(step // t.grad_accum))
            if step >= total:
                break
        logger.epoch(epoch, step)
        if (epoch + 1) % max(t.ckpt_every_epochs, 1) == 0 or step >= total or epoch == t.training_epoch - 1:
            ckpt.save(log_dir, step, state, epoch)
    graphs = train_step.graphs
    if graphs.captures:
        print(f"compiled train step: {sum(graphs.replays.values())} replays of {sum(graphs.captures.values())} "
              f"captured programs (capture {sum(map(sum, graphs.capture_s.values())):.2f} s)")
