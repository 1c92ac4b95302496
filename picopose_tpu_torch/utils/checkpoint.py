"""Model weights from a checkpoint file.

Counterpart of picopose_tpu/utils/checkpoint.py::load_any (:39-57) for
reference PyTorch checkpoints (``.ckpt`` in the Lightning layout, or a raw
``Net`` state dict as ``.pth``), ported through utils/torch_port.py into a
flax-layout variables dict that utils/weights.py::load_flax_variables
loads.  The JAX package's orbax directories are not read here (the port
has no orbax): export them to a torch file first.
"""

from __future__ import annotations

import os

from picopose_tpu_torch.utils.torch_port import load_torch_checkpoint, port_picopose


def load_any(path: str, depth: int = 24) -> dict:
    """A torch checkpoint file -> {'params': ..., 'batch_stats': ...} as
    numpy arrays.  ``depth``: the ViT's block count (24 for ViT-L)."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint?): the PyTorch port reads torch "
            "files only; export it with `python tools/export_torch.py <dir> <out.ckpt>` "
            "on a machine with JAX"
        )
    return port_picopose(load_torch_checkpoint(path), depth=depth)
