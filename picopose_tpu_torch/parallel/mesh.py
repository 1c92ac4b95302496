"""The ('data', 'model') grid of ranks and the batch helpers.

Counterpart of picopose_tpu/parallel/mesh.py:28-50.  The JAX mesh is an
array of devices that one program spans; here it is a grid of ranks, each
a process on its own device, with the process groups that run along its
axes:

  * rank r sits at (r // n_model, r % n_model), as the JAX mesh reshapes
    its device list to (n_data, n_model);
  * the data group of a rank holds the ranks of its column (same model
    coordinate), in data order: gradients, BatchNorm statistics and the
    losses' sums reduce over it; the model group holds its row;
  * a batch-like array is split over 'data' on axis 0: the rank at data
    coordinate d holds rows d*b ... (d+1)*b of the global batch of n_data*b
    (``shard_batch``).

Every rank builds every group, in one order, as ``new_group`` requires.
Outside a process group the mesh is 1 x 1 and has no groups.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from picopose_tpu_torch.device import resolve_device
from picopose_tpu_torch.parallel.distributed import backend, process_info


@dataclass(frozen=True, eq=False)
class Mesh:
    n_data: int
    n_model: int
    rank: int
    device: torch.device
    data_group: Any = None   # None outside a process group
    model_group: Any = None
    backend: str | None = None

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.n_data, "model": self.n_model}

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model


def make_mesh(n_data: int | None = None, n_model: int = 1, device: str | torch.device | None = None) -> Mesh:
    """The mesh over this process group's ranks; ``n_data`` defaults to
    world // n_model.  The grid must cover the world: a rank outside it
    would have nothing to run, and a grid larger than the world raises.
    ``device``: the device this rank computes on, the rank's card unless
    "cpu" is passed (device.py::resolve_device)."""
    rank, world = process_info()
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model != world:
        raise ValueError(
            f"a {n_data} x {n_model} ('data', 'model') mesh needs {n_data * n_model} ranks; "
            f"the process group has {world}"
        )
    device = resolve_device(device)
    if world == 1 and backend() is None:
        return Mesh(1, 1, 0, device)
    data_group = model_group = None
    for m in range(n_model):  # every rank creates every group, in this order
        g = dist.new_group([d * n_model + m for d in range(n_data)])
        if rank % n_model == m:
            data_group = g
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)])
        if rank // n_model == d:
            model_group = g
    return Mesh(n_data, n_model, rank, device, data_group, model_group, backend())


def batch_rows(n: int, mesh: Mesh) -> slice:
    """The rows of an n-row global batch that this rank holds."""
    if n % mesh.n_data:
        raise ValueError(f"a global batch of {n} rows does not split over {mesh.n_data} data ranks")
    b = n // mesh.n_data
    return slice(mesh.data_index * b, (mesh.data_index + 1) * b)


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's rows (axis 0) of every array or tensor of ``batch``, a
    dict or a sequence; the leaves stay where they are (numpy stays numpy)."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    return batch[batch_rows(batch.shape[0], mesh)]


def replicated(tree: Any, mesh: Mesh) -> Any:
    """``tree``'s tensors on this rank's device (every rank holds all of it)."""
    if isinstance(tree, dict):
        return {k: replicated(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicated(v, mesh) for v in tree)
    return torch.as_tensor(tree, device=mesh.device)
