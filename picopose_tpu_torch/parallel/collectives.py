"""Collectives with gradients, and the data group a training forward
reduces over.

The JAX package's sharded step is one global program: its loss is the
loss of the whole global batch, whatever the mesh.  Here each rank runs
its rows, and the few places where the step couples rows across the batch
(BatchNorm's statistics, infoNCE's logit matrix, the losses' means) reduce
over the data group inside ``data_parallel(mesh)``.  Every rank then holds
the same global loss and backpropagates it through its own rows; the data
group's sum of the ranks' gradients is the global loss's gradient, with
each backward choosing what counts a contribution once:

  * ``all_reduce_replicated``: a sum whose result only replicated work
    reads (a loss term's numerator, every rank computing the same scalar
    from it): the backward is the identity, since each rank already holds
    the whole upstream gradient, and summing it would count it n times;
  * ``all_reduce_shared``: a sum that each rank's rows read (BatchNorm's
    statistics): the backward sums the ranks' upstream gradients;
  * ``all_gather_rows``: rows every rank reads (infoNCE's targets): the
    backward reduce-scatters, so each rank gets the gradient of its rows
    from every rank's use of them;
  * ``gather_param``: an fsdp shard gathered along an axis for the step,
    its gradient reduce-scattered back to the shard.

Tensor parallelism (Megatron) runs inside ``model_parallel(mesh)`` on the
model group, whose ranks hold the same rows: ``to_model_parallel`` (f:
the identity forward, a sum of the ranks' gradients backward) enters a
column-parallel layer, ``from_model_parallel`` (g: a sum of the ranks'
partial outputs forward, the identity backward) leaves a row-parallel
one, so the replicated activations and their gradients, and with them
the replicated parameters' gradients, are the same on every model rank.

``ISSUED`` counts the collectives issued, by kind: a CUDA graph captures
them once and replays them unseen, as it does kernel launches.  A failed
collective raises; nothing retries or falls back.
"""

from __future__ import annotations

import collections
import contextlib
import threading

import torch
import torch.distributed as dist

# torch 2.13 renames the flat-tensor collectives; 2.11 has only the old names
_all_gather_flat = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_flat = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor

ISSUED: collections.Counter = collections.Counter()

_local = threading.local()


@contextlib.contextmanager
def data_parallel(mesh):
    """Reduce the training forward over ``mesh``'s data group (when it has
    more than one rank) inside this context."""
    prev = getattr(_local, "mesh", None)
    _local.mesh = mesh if mesh is not None and mesh.n_data > 1 else None
    try:
        yield
    finally:
        _local.mesh = prev


def data_mesh():
    """The mesh set by the innermost ``data_parallel``, or None."""
    return getattr(_local, "mesh", None)


@contextlib.contextmanager
def model_parallel(mesh):
    """Run the tensor-parallel layers over ``mesh``'s model group (when it
    has more than one rank) inside this context."""
    prev = getattr(_local, "model_mesh", None)
    _local.model_mesh = mesh if mesh is not None and mesh.n_model > 1 else None
    try:
        yield
    finally:
        _local.model_mesh = prev


def model_mesh():
    """The mesh set by the innermost ``model_parallel``, or None."""
    return getattr(_local, "model_mesh", None)


def size(group) -> int:
    return dist.get_world_size(group)


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    ISSUED["all_reduce"] += 1
    dist.all_reduce(x, group=group)
    return x


def all_gather0(x: torch.Tensor, group) -> torch.Tensor:
    """(n * x.shape[0], ...): the group's tensors stacked on axis 0, in
    group-rank order."""
    ISSUED["all_gather"] += 1
    x = x.contiguous()
    out = torch.empty((size(group) * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    _all_gather_flat(out, x, group=group)
    return out


def reduce_scatter0(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group of ``x``, split on axis 0: this rank's part."""
    ISSUED["reduce_scatter"] += 1
    x = x.contiguous()
    n = size(group)
    out = torch.empty((x.shape[0] // n, *x.shape[1:]), dtype=x.dtype, device=x.device)
    _reduce_scatter_flat(out, x, group=group)
    return out


class _AllReduceReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceShared(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather0(x, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter0(g, ctx.group), None


def all_reduce_replicated(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceReplicated.apply(x, group)


def all_reduce_shared(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceShared.apply(x, group)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    return _AllGatherRows.apply(x, group)


def gather_axis(shard: torch.Tensor, axis: int, group) -> torch.Tensor:
    """The group's shards of one tensor joined along ``axis`` (contiguous)."""
    full = all_gather0(shard.movedim(axis, 0), group)
    return full.movedim(0, axis).contiguous()


def scatter_axis(full: torch.Tensor, axis: int, group) -> torch.Tensor:
    """The group's sum of ``full``, this rank's part along ``axis``."""
    return reduce_scatter0(full.movedim(axis, 0), group).movedim(0, axis).contiguous()


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, axis, group):
        ctx.axis, ctx.group = axis, group
        return gather_axis(shard, axis, group)

    @staticmethod
    def backward(ctx, g):
        return scatter_axis(g, ctx.axis, ctx.group), None, None


def gather_param(shard: torch.Tensor, axis: int, group) -> torch.Tensor:
    """An fsdp shard gathered to the whole parameter along ``axis``; its
    gradient is reduce-scattered back (summed over the group)."""
    return _GatherParam.apply(shard, axis, group)


class _ToModelParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


def to_model_parallel(x: torch.Tensor, mesh) -> torch.Tensor:
    """Megatron's f, at the input of a column-parallel layer."""
    return _ToModelParallel.apply(x, mesh.model_group)


def from_model_parallel(x: torch.Tensor, mesh) -> torch.Tensor:
    """Megatron's g, at the output of a row-parallel layer (before its
    bias, which is added once)."""
    return all_reduce_replicated(x.contiguous(), mesh.model_group)
