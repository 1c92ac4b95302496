"""Device selection: CUDA unless the caller names the CPU, never a silent fallback."""

from __future__ import annotations

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
