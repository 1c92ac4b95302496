"""Device selection: CUDA unless the caller names the CPU, never a silent
fallback; the fp32 precision the port's fp32 stages need; and cuDNN's
deterministic algorithms for the training step."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """Return the device an entry point runs on.

    ``None`` means CUDA.  A CUDA device with no card present raises: the
    port never moves to the CPU on its own; pass ``device="cpu"`` for that.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present; pass device='cpu' to run on the CPU"
        )
    return dev


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
