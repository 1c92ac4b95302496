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
loads, or from a directory: the JAX package's orbax checkpoint (a
``CheckpointManager`` step directory or its item directory), read by
utils/orbax_read.py without JAX, its ``params`` and ``batch_stats`` taken
as they are (a training checkpoint's ``TrainState`` unwrapped, as the JAX
package's entry points unwrap it).

A JAX training run resumes here too: ``latest_step`` counts the JAX
package's ``<step>/`` directories beside the port's ``<step>.pt`` files
(the ``.pt`` wins at a step that has both), and ``restore`` of a
``<step>/`` directory maps its ``TrainState`` (step, params, batch_stats;
optax's Adam moments and count, or SGD's trace; ``MultiSteps``'
``mini_step`` and accumulated gradients) into the port's layout and
restores it as a ``.pt`` file of the same content would be restored.
Under ranks each rank decodes only the zarr chunks that meet its part of
each leaf (``rank_region``), as orbax's restore into a sharded template
reads for the JAX loop: its shard of a split parameter and of its
moments, and of the accumulated gradients what ``local_optimizer_state``
keeps (nothing of a gradient not split over 'data' off data rank 0).
"""

from __future__ import annotations

import os
import pickle

import torch

import numpy as np

from picopose_tpu_torch.parallel.distributed import all_hosts_barrier, process_info
from picopose_tpu_torch.parallel.shardings import (
    flax_ranges, full_optimizer_state, full_state_dict, local_optimizer_state, shard_of,
)
from picopose_tpu_torch.utils.orbax_read import read_step_dir
from picopose_tpu_torch.utils.torch_export import export_state_dict
from picopose_tpu_torch.utils.torch_port import load_torch_checkpoint, port_picopose
from picopose_tpu_torch.utils.weights import state_dict_from_flax
from picopose_tpu_torch.utils.zarr2 import Region

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


def saved_steps(log_dir: str) -> set[int]:
    """The steps saved under ``log_dir``: the port's ``<step>.pt`` files
    and the JAX package's orbax ``<step>/`` directories (every directory
    named by a number, as the JAX entry points count them; one that is not
    an orbax checkpoint raises when it is read)."""
    d = checkpoint_dir(log_dir)
    names = os.listdir(d) if os.path.isdir(d) else []
    return {int(n.removesuffix(".pt")) for n in names if n.removesuffix(".pt").isdigit()}


def latest_step(log_dir: str) -> int | None:
    """The highest step saved under ``log_dir`` (``saved_steps``), or None."""
    steps = saved_steps(log_dir)
    return max(steps) if steps else None


def step_path(log_dir: str, step: int) -> str:
    """The save of ``step``: its ``.pt`` file, else its orbax directory."""
    path = checkpoint_path(log_dir, step)
    return path if os.path.exists(path) else os.path.join(checkpoint_dir(log_dir), str(step))


def restore(log_dir: str, step: int | None, state):
    """Load the save at ``step`` (the latest when None; ``step_path``) into
    ``state`` in place (every tensor keeps its address) and return it."""
    step = latest_step(log_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {checkpoint_dir(log_dir)}")
    path = step_path(log_dir, step)
    what = f"checkpoint at step {step}"
    if not os.path.isdir(path):
        return load_payload(state, torch.load(path, map_location=state.model.device, weights_only=True), what)
    local = getattr(state, "layout", None) is not None
    tree = read_step_dir(path, region=rank_region(state) if local else None)
    return load_payload(state, train_payload_from_tree(tree, state, path), what, local=local)


_MOMENTS = ("mu", "nu", "trace", "acc_grads")


def rank_region(state):
    """A leaf's key path in the JAX package's ``TrainState`` -> the part
    of it (utils/zarr2.py's region) that this rank restores under
    ``state.layout``: a split parameter's shard and its moments' (optax's
    ``mu``, ``nu``, ``trace``, ``MultiSteps``' ``acc_grads``), nothing of
    an accumulated gradient that ``local_optimizer_state`` zeroes here,
    and all of every other leaf (None)."""
    layout = state.layout
    parts = {}  # flax path under params/ -> (ranges or None, zeroed here, axes)
    for name, spec, shape in zip(layout.names, layout.specs, layout.shapes):
        path, ranges = flax_ranges(state.model, name, shape, spec, layout.mesh)
        zeroed = spec.data is None and layout.mesh.data_index != 0
        parts[path[len("params/"):]] = (ranges if spec.split else None, zeroed, len(shape))

    def region(keys: tuple) -> Region | None:
        keys = [str(k) for k in keys]
        at = None  # the key after which the parameter's flax path follows
        if keys[0] == "params":
            at = 0
        elif keys[0] == "opt_state":
            at = next((i for i, k in enumerate(keys) if k in _MOMENTS), None)
        part = None if at is None else parts.get("/".join(keys[at + 1:]))
        if part is None:
            return None
        ranges, zeroed, ndim = part
        return [[]] * ndim if zeroed and keys[at] == "acc_grads" else ranges

    return region


def load_payload(state, payload: dict, what: str, local: bool = False):
    """Copy ``payload`` (``save``'s layout) into ``state`` in place and
    return it; under ranks each rank keeps its shards, or with ``local``
    the payload holds them already (``rank_region``'s parts; a gradient
    left out, None, is zeroed).  ``what`` names the payload in errors."""
    layout = getattr(state, "layout", None)
    if layout is None:
        state.model.load_state_dict(payload["model"])  # copies into the parameters and buffers
    else:
        model = dict(payload["model"])
        with torch.no_grad():
            for name, spec, t in layout.split():
                part = model.pop(name)
                part = part if local else shard_of(part, spec, layout.mesh)
                if part.shape != t.shape:
                    raise ValueError(f"{what}: {name} has shape {tuple(part.shape)} here, {tuple(t.shape)} expected")
                t.copy_(part)
        missing, unexpected = state.model.load_state_dict(model, strict=False)
        if sorted(missing) != sorted(n for n, _, _ in layout.split()) or unexpected:
            raise ValueError(f"{what}: layout mismatch (missing {missing[:3]}, unexpected {unexpected[:3]})")
        if not local:
            payload = local_optimizer_state(payload, layout.specs, layout.mesh)
    try:
        state.optimizer.load_state_dict(payload)
    except ValueError as e:
        raise ValueError(f"{what}: {e}") from None
    state.step = payload["step"]
    return state


def orbax_variables(path: str) -> dict:
    """The JAX package's orbax checkpoint at ``path`` -> {'params': ...,
    'batch_stats': ...} as numpy arrays: a variables checkpoint as it is, a
    ``TrainState`` without its step and optimizer state (which are not
    read).  Raises ValueError naming ``path`` for a directory that is not
    an orbax checkpoint."""
    tree = read_step_dir(path, top=("params", "batch_stats"))
    if "params" not in tree:
        raise ValueError(f"{path}: an orbax checkpoint with no 'params' (top-level keys {sorted(tree)})")
    return {"params": tree["params"], "batch_stats": tree.get("batch_stats", {})}


def read_weights(path: str) -> dict:
    """The weights a checkpoint holds: for a torch file, as
    utils/torch_port.py reads them: a reference checkpoint (Lightning
    ``.ckpt``, raw ``Net`` state dict, or a DINOv2 backbone) as it is
    stored; a train state this module saved as the reference ``Net`` state
    dict its model exports to (utils/torch_export.py).  For a directory,
    the JAX package's orbax checkpoint as flax variables
    (``orbax_variables``)."""
    if os.path.isdir(path):
        return orbax_variables(path)
    try:
        raw = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:  # a Lightning .ckpt holds more than tensors
        raw = load_torch_checkpoint(path)
    if isinstance(raw, dict) and _TRAIN_STATE_KEYS <= set(raw):
        return export_state_dict(raw["model"])
    return raw


def load_any(path: str, depth: int = 24) -> dict:
    """A checkpoint file or the JAX package's orbax directory
    (``read_weights``) -> {'params': ..., 'batch_stats': ...} as numpy
    arrays.  ``depth``: the ViT's block count (24 for ViT-L), for a torch
    file."""
    if os.path.isdir(path):
        return orbax_variables(path)
    return port_picopose(read_weights(path), depth=depth)


def _opt_parts(opt_state, what: str) -> tuple[dict | None, list]:
    """optax's state as the JAX package builds it (train/step.py::
    make_optimizer) -> (MultiSteps' state or None, the inner chain's
    states)."""
    multi = opt_state if isinstance(opt_state, dict) and "inner_opt_state" in opt_state else None
    chain = multi["inner_opt_state"] if multi else opt_state
    if not isinstance(chain, list):
        raise ValueError(f"{what}: opt_state is not an optax chain (a {type(chain).__name__})")
    return multi, chain


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A view of ``a`` where torch can take its strides (a transposed
    kernel: the copy into the state's tensor transposes it), else a copy
    (a flipped one)."""
    return torch.from_numpy(a if all(st >= 0 for st in a.strides) else np.ascontiguousarray(a))


def train_payload_from_tree(tree: dict, state, what: str) -> dict:
    """The JAX package's ``TrainState`` as ``read_step_dir`` reads it
    (``what`` names it in errors) -> the payload ``save`` writes for
    ``state`` (train/step.py::TrainState): the model's
    state dict, the optimizer's moments by parameter index, its update
    count, ``mini_step`` and the accumulated gradients, and the step.

    optax's states map so: ``ScaleByAdamState`` ``mu`` / ``nu`` /
    ``count`` -> ``exp_avg`` / ``exp_avg_sq`` / the update count (Adam,
    AdamW); ``TraceState`` ``trace`` -> ``momentum_buffer`` and the
    schedule's ``count`` -> the update count (SGD); ``MultiStepsState``
    ``mini_step`` as it is, and ``acc_grads``, a running mean over the
    ``mini_step`` gradients so far, times ``mini_step`` -> the port's
    summed gradients.  Each tree goes through the flax-to-port name and
    layout map of utils/weights.py."""
    missing = {"step", "params", "opt_state"} - set(tree)
    if missing:
        raise ValueError(f"{what}: not a TrainState checkpoint (no {sorted(missing)})")
    stats = tree.get("batch_stats", {})
    opt = state.optimizer
    multi, chain = _opt_parts(tree["opt_state"], what)
    if (multi is not None) != (opt.grad_accum > 1):
        raise ValueError(f"{what}: saved {'with' if multi else 'without'} gradient accumulation "
                         f"(optax.MultiSteps), the optimizer has grad_accum {opt.grad_accum}")
    adam = [s for s in chain if isinstance(s, dict) and {"mu", "nu", "count"} <= set(s)]
    trace = [s for s in chain if isinstance(s, dict) and "trace" in s]
    sched = [s for s in chain if isinstance(s, dict) and set(s) == {"count"}]
    kind = "SGD" if opt.spec.opt_type == "SGD" else "Adam"
    if (kind == "SGD" and not (trace and sched)) or (kind == "Adam" and not adam):
        raise ValueError(f"{what}: the saved optimizer state is not {opt.spec.opt_type}'s "
                         f"(its states hold {[sorted(s) if isinstance(s, dict) else s for s in chain]})")
    layout = getattr(state, "layout", None)
    if layout is not None:  # the optimizer holds the rank's shards
        names = layout.names
    else:
        name_of = {id(p): n for n, p in state.model.named_parameters()}
        names = [name_of[id(p)] for p in opt.params]
    as_port = lambda t: {k: _tensor(v) for k, v in state_dict_from_flax({"params": t, "batch_stats": stats}).items()}
    model = as_port(tree["params"])
    moments = ({"momentum_buffer": as_port(trace[0]["trace"])} if kind == "SGD"
               else {"exp_avg": as_port(adam[0]["mu"]), "exp_avg_sq": as_port(adam[0]["nu"])})
    count = int(np.asarray((sched if kind == "SGD" else adam)[0]["count"]))
    mini_step = int(np.asarray(multi["mini_step"])) if multi else 0
    grads = None
    if mini_step:
        acc = as_port(multi["acc_grads"])
        grads = [acc[n] * mini_step if acc[n].numel() else None for n in names]  # None: a part left out
    return {
        "model": model,
        "optimizer": {"state": {i: {k: m[n] for k, m in moments.items()} for i, n in enumerate(names)}},
        "scheduler": {"last_epoch": count},
        "mini_step": mini_step,
        "grads": grads,
        "step": int(np.asarray(tree["step"])),
        "epoch": 0,
    }
