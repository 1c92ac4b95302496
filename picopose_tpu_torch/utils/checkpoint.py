"""Checkpoints: train states saved and restored, and model weights from any
checkpoint file.

Counterpart of picopose_tpu/utils/checkpoint.py, where orbax keeps one
step directory per save under ``<log_dir>/checkpoints/`` and keeps every
one (the reference's ``save_top_k=-1``, run_train.py:99-102).  Here a save
is one file, ``<log_dir>/checkpoints/<step>.pt``, written with
``torch.save`` (to a temporary name, then renamed, so a file that exists is
whole) and read with ``weights_only=True``.  It holds the model's state
dict (parameters and BatchNorm statistics), the optimizer's moments in the
``torch.optim`` layout and its update count as ``LambdaLR``'s
``last_epoch`` (train/step.py::Optimizer.state_dict: the layout the port
wrote when its update was ``torch.optim``'s, so files of either read
back), ``mini_step`` and, in the middle of a gradient accumulation, the
summed gradients, the step and the epoch.  ``restore`` copies all of it
into the state's tensors in place, so a step captured before the restore
(train/step.py::make_train_step) replays on the restored state.

Under ranks (a state laid out by parallel/shardings.py::shard_state) the
file is the one one device writes: every rank gathers the split
parameters and moments and sums the replicated gradients of an open
accumulation (collectives), rank 0 writes, and every rank waits for it;
``restore`` reads the whole state and keeps the rank's shards, so a run
saved at one world size resumes at another, as orbax lets the JAX loop.

``load_any`` reads model weights from such a file or from a reference
PyTorch checkpoint (``.ckpt`` in the Lightning layout, or a raw ``Net``
state dict as ``.pth``), ported through utils/torch_port.py into a
flax-layout variables dict that utils/weights.py::load_flax_variables
loads.  The JAX package's orbax directories are not read here (the port
has no orbax): export them to a torch file first.
"""

from __future__ import annotations

import os
import pickle

import torch

from picopose_tpu_torch.parallel.distributed import all_hosts_barrier, process_info
from picopose_tpu_torch.parallel.shardings import full_optimizer_state, full_state_dict, local_optimizer_state, shard_of
from picopose_tpu_torch.utils.torch_export import export_state_dict
from picopose_tpu_torch.utils.torch_port import load_torch_checkpoint, port_picopose

_TRAIN_STATE_KEYS = {"model", "optimizer", "scheduler", "mini_step", "step", "epoch"}


def checkpoint_dir(log_dir: str) -> str:
    return os.path.join(log_dir, "checkpoints")


def checkpoint_path(log_dir: str, step: int) -> str:
    return os.path.join(checkpoint_dir(log_dir), f"{step}.pt")


def save(log_dir: str, step: int, state, epoch: int) -> str:
    """Write ``state`` (train/step.py::TrainState) as
    ``<log_dir>/checkpoints/<step>.pt``; returns the path."""
    payload = {
        "model": full_state_dict(state),
        **full_optimizer_state(state),
        "step": int(step),
        "epoch": int(epoch),
    }
    path = checkpoint_path(log_dir, step)
    if process_info()[0] == 0:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)
    all_hosts_barrier("checkpoint")
    return path


def latest_step(log_dir: str) -> int | None:
    """The highest step saved under ``log_dir``, or None."""
    d = checkpoint_dir(log_dir)
    steps = [int(n[:-3]) for n in os.listdir(d) if n.endswith(".pt") and n[:-3].isdigit()] if os.path.isdir(d) else []
    return max(steps) if steps else None


def restore(log_dir: str, step: int | None, state):
    """Load the save at ``step`` (the latest when None) into ``state`` in
    place (every tensor keeps its address) and return it."""
    step = latest_step(log_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {checkpoint_dir(log_dir)}")
    payload = torch.load(checkpoint_path(log_dir, step), map_location=state.model.device, weights_only=True)
    layout = getattr(state, "layout", None)
    if layout is None:
        state.model.load_state_dict(payload["model"])  # copies into the parameters and buffers
    else:
        model = dict(payload["model"])
        with torch.no_grad():
            for name, spec, t in layout.split():
                t.copy_(shard_of(model.pop(name), spec, layout.mesh))
        missing, unexpected = state.model.load_state_dict(model, strict=False)
        if sorted(missing) != sorted(n for n, _, _ in layout.split()) or unexpected:
            raise ValueError(f"checkpoint at step {step}: layout mismatch (missing {missing[:3]}, "
                             f"unexpected {unexpected[:3]})")
        payload = local_optimizer_state(payload, layout.specs, layout.mesh)
    try:
        state.optimizer.load_state_dict(payload)
    except ValueError as e:
        raise ValueError(f"checkpoint at step {step}: {e}") from None
    state.step = payload["step"]
    return state


def read_weights(path: str) -> dict:
    """The weights a torch checkpoint file holds, as utils/torch_port.py
    reads them: a reference checkpoint (Lightning ``.ckpt``, raw ``Net``
    state dict, or a DINOv2 backbone) as it is stored; a train state this
    module saved as the reference ``Net`` state dict its model exports to
    (utils/torch_export.py)."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint?): the PyTorch port reads torch "
            "files only; export it with `python tools/export_torch.py <dir> <out.ckpt>` "
            "on a machine with JAX"
        )
    try:
        raw = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:  # a Lightning .ckpt holds more than tensors
        raw = load_torch_checkpoint(path)
    if isinstance(raw, dict) and _TRAIN_STATE_KEYS <= set(raw):
        return export_state_dict(raw["model"])
    return raw


def load_any(path: str, depth: int = 24) -> dict:
    """A checkpoint file (``read_weights``) -> {'params': ...,
    'batch_stats': ...} as numpy arrays.  ``depth``: the ViT's block count
    (24 for ViT-L)."""
    return port_picopose(read_weights(path), depth=depth)
