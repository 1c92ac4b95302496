"""Profiling and timing helpers.

The port's counterpart of picopose_tpu/utils/profiling.py (:21-65):

  * ``timed(fn)``: mean wall seconds per call after warm-up calls, the
    device synchronised around the timed calls where the JAX module blocks
    on the result;
  * ``trace(dir)``: a ``torch.profiler`` context that writes a Chrome
    trace (``trace.json``) into ``dir``, CPU and, when CUDA is in use, CUDA
    activity;
  * ``StageTimer``: named accumulators of wall time for per-stage
    breakdowns, each section synchronised as the JAX module's
    ``effects_barrier`` does; ``report()`` has the JAX module's format.

Synchronising means ``torch.cuda.synchronize()`` when CUDA is in use
(initialised in this process); nothing here starts CUDA or imports torch
on its own, so the host-only entry points that time their parts with it
(render_templates) start without torch.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from collections import defaultdict


def synchronize() -> None:
    """Wait for the device's queued work, when CUDA is in use."""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed(fn, *args, warmup: int = 1, iters: int = 5, **kwargs):
    """Returns (mean_seconds, last_result) with device-sync timing."""
    result = None
    for _ in range(warmup):
        result = fn(*args, **kwargs)
    synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        result = fn(*args, **kwargs)
    synchronize()
    return (time.perf_counter() - t0) / iters, result


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler context writing ``log_dir/trace.json`` (open it in
    Perfetto or chrome://tracing)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StageTimer:
    """Accumulate named wall-time segments (host-side, device-synced)."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str, sync: bool = True):
        t0 = time.perf_counter()
        yield
        if sync:
            # sync anything pending so the section charge is honest
            synchronize()
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> str:
        return " | ".join(
            f"{k}: {self.totals[k]:.3f}s/{self.counts[k]}"
            for k in sorted(self.totals)
        )
