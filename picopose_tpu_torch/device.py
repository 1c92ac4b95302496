"""Device selection: CUDA unless the caller names the CPU, never a silent
fallback, and a rank's own card under ``torchrun``; the fp32 precision the
port's fp32 stages need; cuDNN's deterministic algorithms for the
training step; and ATen's CPU convolutions for it, in oneDNN's stead."""

from __future__ import annotations

import contextlib
import os

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """Return the device an entry point runs on.

    ``None`` means CUDA.  A CUDA device with no card present raises: the
    port never moves to the CPU on its own; pass ``device="cpu"`` for that.
    In a process that ``torchrun`` started, CUDA without an index is the
    rank's card, ``cuda:LOCAL_RANK``.  A card index beyond the cards
    present raises.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present; pass device='cpu' to run on the CPU"
        )
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if dev.type == "cuda" and dev.index is not None and dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"{dev} requested but {torch.cuda.device_count()} CUDA device(s) are present")
    return dev


def indexed(device: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current>``, so that one card compares equal
    however it was named."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@contextlib.contextmanager
def full_fp32():
    """Run fp32 matmuls and convolutions in full fp32 on the card.

    Sets ``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32`` to False and restores the caller's
    values on every exit, a raise included.  PyTorch's default lets cuDNN
    take TF32 (a 10-bit mantissa) for fp32 convolutions; the JAX package
    computes these stages in fp32 (stage 2, the geometry, the crops, PnP).
    bf16 work is untouched: the flags apply to fp32 operands only.

    The flags are process-global: another thread that runs fp32 work on
    the card while this context is open runs it without TF32 too.  Usable
    as a decorator (each call enters its own context).
    """
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


@contextlib.contextmanager
def deterministic_cudnn():
    """Let cuDNN take only deterministic algorithms; restore the caller's
    ``torch.backends.cudnn.deterministic`` on every exit.

    cuDNN's own choice for some weight gradients is its algorithm 0, which
    sums with atomics in no fixed order: at ViT-L, batch 8, the stage-2
    head's fp32 1x1 conv (256 -> 256 on channels-last 16^2 maps) gave two
    runs of one gradient a few ulps apart, eagerly and under a CUDA graph
    capture alike.  Process-global, as ``full_fp32``; usable as a decorator.
    """
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


@contextlib.contextmanager
def aten_cpu_convs():
    """Run the CPU's convolutions on ATen's own kernels, not oneDNN's;
    restore the caller's ``torch.backends.mkldnn.enabled`` on every exit.

    On an AVX-512 host (an AMD EPYC, torch 2.13 at CPU capability AVX512;
    tests/torch_float64_distances.py) oneDNN's fp32 convolutions on
    channels-last maps round about four times coarser than ATen's: 1.18e-6
    against 2.79e-7 relative RMS from float64 for the DPT head's 3 x 3
    stride-2 resize (1024 channels, 16^2 -> 8^2).  The training step
    amplifies that through its train-mode BatchNorms: at
    ``vit_tiny_test`` the DPT head's gradient came out 2.12e-3 (relative
    RMS) from a float64 evaluation of the same step with oneDNN, 5.19e-5
    with ATen's kernels, where the JAX package's CPU step is 5.43e-5 from
    it.  The flag governs CPU operators
    only: the card's work and its CUDA graphs do not change.
    Process-global, as ``full_fp32``; usable as a decorator.
    """
    saved = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = saved
