"""Training observability: file and console logger, windowed loss averages,
TensorBoard output.

The port's own copy of picopose_tpu/utils/logging.py (``get_logger``,
``LossMeter``, ``TrainLogger``; the reference's utils/logging.py:20-156 and
utils/log_buffer.py:9-144): per-term losses averaged over the print
window, epoch summaries, the learning rate and iterations per second.

``TrainLogger.step_async`` keeps each step's loss tensors on the device
and reads all of them back in one transfer at each print boundary and at
``epoch``, as the JAX package's ``jax.device_get`` does, so the training
loop never waits for the device between print boundaries.  TensorBoard
scalars are written when ``tensorboardX`` imports.
"""

from __future__ import annotations

import logging
import os
import time
from collections import defaultdict, deque

import torch


def get_logger(log_dir: str, name: str = "picopose_tpu_torch") -> logging.Logger:
    """One logger per log directory, writing ``training_logger.log`` there
    and to the console."""
    os.makedirs(log_dir, exist_ok=True)
    # a process may train several versions (the tests do): a logger cached
    # by name alone would keep writing the first run's file
    logger = logging.getLogger(f"{name}.{abs(hash(os.path.abspath(log_dir)))}")
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("[%(asctime)s] %(message)s", "%m-%d %H:%M:%S")
    for h in (
        logging.FileHandler(os.path.join(log_dir, "training_logger.log")),
        logging.StreamHandler(),
    ):
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger


class LossMeter:
    """Windowed scalar averaging (HistoryBuffer semantics,
    utils/log_buffer.py:9-69)."""

    def __init__(self, window: int = 100):
        self.window = window
        self.buffers: dict[str, deque] = defaultdict(lambda: deque(maxlen=self.window))
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    def update(self, scalars: dict[str, float]) -> None:
        for k, v in scalars.items():
            v = float(v)
            self.buffers[k].append(v)
            self.totals[k] += v
            self.counts[k] += 1

    def window_avg(self, key: str) -> float:
        b = self.buffers[key]
        return sum(b) / max(len(b), 1)

    def global_avg(self, key: str) -> float:
        return self.totals[key] / max(self.counts[key], 1)

    def line(self) -> str:
        return ", ".join(f"{k}: {self.window_avg(k):.4f}" for k in sorted(self.buffers))


class TrainLogger:
    """Iteration and epoch logging cadence (MyPrintingCallback semantics)."""

    def __init__(self, log_dir: str, every: int = 100, tensorboard: bool = True):
        self.logger = get_logger(log_dir)
        self.meter = LossMeter(window=every)
        self.every = every
        self.t0 = time.time()
        self._pending: list[dict[str, torch.Tensor]] = []
        self.tb = None
        if tensorboard:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                pass
            else:
                self.tb = SummaryWriter(log_dir)

    def _fetch(self) -> None:
        """Every pending step's losses to the host in one transfer."""
        if not self._pending:
            return
        keys = list(self._pending[0])
        values = torch.stack([torch.stack([s[k].detach().float().reshape(()) for k in keys])
                              for s in self._pending]).cpu().tolist()
        for row in values:
            self.meter.update(dict(zip(keys, row)))
        self._pending.clear()

    def step_async(self, step: int, device_scalars: dict[str, torch.Tensor], lr: float) -> None:
        """Record a step without waiting for the device: the loss tensors
        are buffered and read back at the next print boundary (every
        ``every`` steps; the reference's cadence, utils/logging.py:149-155)."""
        self._pending.append(device_scalars)
        if step % self.every == 0:
            self._fetch()
            self._emit(step, lr)

    def step(self, step: int, scalars: dict[str, float], lr: float) -> None:
        self.meter.update(scalars)
        if step % self.every == 0:
            self._emit(step, lr)

    def _emit(self, step: int, lr: float) -> None:
        rate = self.every / max(time.time() - self.t0, 1e-9)
        self.t0 = time.time()
        self.logger.info(f"iter {step} | lr {lr:.3e} | {rate:.2f} it/s | {self.meter.line()}")
        if self.tb:
            for k in self.meter.buffers:
                self.tb.add_scalar(k, self.meter.window_avg(k), step)
            self.tb.add_scalar("lr", lr, step)

    def epoch(self, epoch: int, step: int) -> None:
        self._fetch()
        self.logger.info(
            f"epoch {epoch} done at iter {step} | "
            + ", ".join(f"{k}(avg): {self.meter.global_avg(k):.4f}" for k in sorted(self.meter.buffers))
        )
