"""Parameter and optimizer sharding rules: ddp, fsdp (and the tensor-parallel
rules of tp / fsdp_tp), and the sharded train state.

Counterpart of picopose_tpu/parallel/shardings.py:37-133.  The rule table
is a copy of the JAX package's, keyed on the same flax paths: each port
parameter is named by the flax path utils/weights.py fills it from
(``flax_leaf``), so both packages shard the same leaves along the same
axes, read back onto the port tensor's axes (a Dense kernel (in, out) is
the port's (out, in) weight, a conv's HWIO its OIHW):

  * ``ddp``: every leaf replicated, the batch over 'data';
  * ``fsdp``: each leaf of at least 2^14 elements split over 'data' along
    its largest divisible axis; its AdamW moments with it;
  * ``tp``: Megatron column / row splits over 'model' of the ViT's
    qkv / fc1 / w12 and proj / fc2 / w3 and the affine head's fc1 -> fc2;
  * ``fsdp_tp``: both.

``shard_state`` lays a train state out as the rules say: each rank keeps
its shard of every split leaf (the module's parameter becomes an empty
placeholder) and the optimizer runs on the rank's tensors, so a split
leaf's moments and gradient are shards too; the gradients of the leaves
not split over 'data' (replicated, or a model rank's part) live in flat
buckets that the step reduces over the data group.
``full_state_dict`` / ``full_optimizer_state`` gather it back (every rank
calls them: they are collectives).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from picopose_tpu_torch.parallel.collectives import all_reduce_, gather_axis
from picopose_tpu_torch.parallel.mesh import Mesh

MODES = ("ddp", "fsdp", "tp", "fsdp_tp")

# Megatron split: column-parallel into the nonlinearity, row-parallel out
# of it, on flax paths (Dense kernels are (in, out)); the same names end
# the optimizer moments' paths, so one table covers both.
_TP_COL = re.compile(r"(qkv|fc1|w12)/(kernel|bias)$")
_TP_ROW = re.compile(r"(proj|fc2|w3)/kernel$")

# leaves smaller than this stay replicated under fsdp
_FSDP_MIN_SIZE = 1 << 14


def _tp_spec(pstr: str, shape: tuple[int, ...], n_model: int):
    m = _TP_COL.search(pstr)
    if m is not None:  # column parallel: the output (last) axis of kernel and bias
        if shape[-1] % n_model != 0:
            return None
        return [None] * (len(shape) - 1) + ["model"]
    if _TP_ROW.search(pstr) is not None and len(shape) >= 2:  # row parallel: the input axis
        if shape[0] % n_model != 0:
            return None
        return ["model"] + [None] * (len(shape) - 1)
    return None


def _fsdp_axis(spec: list, shape: tuple[int, ...], n_data: int) -> list:
    """'data' on the largest still-free divisible axis (ZeRO-3)."""
    if int(np.prod(shape)) < _FSDP_MIN_SIZE:
        return spec
    free = [i for i, d in enumerate(shape) if spec[i] is None and d % n_data == 0 and d >= n_data]
    if not free:
        return spec
    best = max(free, key=lambda i: shape[i])
    spec = list(spec)
    spec[best] = "data"
    return spec


def leaf_spec(pstr: str, shape: tuple[int, ...], mode: str, n_data: int, n_model: int) -> tuple:
    """The partition spec of one leaf, on its flax path and flax shape: a
    tuple of 'data' / 'model' / None per axis, without trailing Nones (the
    JAX ``PartitionSpec``'s canonical form)."""
    if mode not in MODES:
        raise ValueError(f"unknown parallel mode {mode!r}; one of {MODES}")
    spec: list = [None] * len(shape)
    if mode in ("tp", "fsdp_tp") and n_model > 1:
        tp = _tp_spec(pstr, shape, n_model)
        if tp is not None:
            spec = tp
    if mode in ("fsdp", "fsdp_tp") and n_data > 1:
        spec = _fsdp_axis(spec, shape, n_data)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return tuple(spec)


# ---------------------------------------------------------------- flax paths of the port's tensors

# flax axis i of a kernel is the port weight's axis PERM[i], by the class
# of models/layers.py that holds it; utils/weights.py flips a
# ConvTranspose kernel's flax axes 0 and 1
_PERMS = {"Linear": (1, 0), "Conv2d": (2, 3, 1, 0), "ConvTranspose2d": (2, 3, 0, 1)}
_FLIPPED = {"ConvTranspose2d": (0, 1)}
_LEVEL_LISTS = {"proj_conv": "proj_{}_conv", "proj_bn": "proj_{}_bn"}


def flax_leaf(model: nn.Module, name: str, ndim: int) -> tuple[str, tuple[int, ...]]:
    """(flax path, flax axis -> port axis) of the port parameter or buffer
    ``name`` of ``ndim`` axes: the inverse of utils/weights.py's layout
    rules.  BatchNorm statistics are ``batch_stats`` leaves, the rest
    ``params``."""
    *mods, leaf = name.split(".")
    module = model.get_submodule(".".join(mods))
    parts: list[str] = []
    for tok in mods:
        if tok.isdigit():
            prev = parts.pop()
            parts.append(_LEVEL_LISTS[prev].format(tok) if prev in _LEVEL_LISTS else f"{prev}_{tok}")
        else:
            parts.append(tok)
    perm = _PERMS.get(type(module).__name__)
    if leaf == "weight":
        leaf = "kernel" if perm is not None else "scale"
    elif leaf in ("running_mean", "running_var"):
        return "batch_stats/" + "/".join(parts + [leaf[len("running_"):]]), (0,)
    if perm is None or leaf != "kernel":
        perm = tuple(range(ndim))
    return "params/" + "/".join(parts + [leaf]), perm


class Spec(NamedTuple):
    """A port tensor's split: the axis over 'data', the axis over 'model'
    and ``blocks``, the equal blocks of the model axis that each model
    rank takes its part of.  The JAX package splits a column-parallel
    kernel in contiguous chunks; the port splits qkv by heads (each rank
    holds q, k and v of its heads: 3 blocks) and SwiGLU's w12 by hidden
    unit (gate and value: 2 blocks), so that each rank computes whole
    heads and units; ``shard_of`` / ``gather_full`` convert at the
    boundary."""

    data: int | None = None
    model: int | None = None
    blocks: int = 1

    @property
    def split(self) -> bool:
        return self.data is not None or self.model is not None


def _blocks(flax_path: str) -> int:
    return 3 if "/qkv/" in flax_path else 2 if "/w12/" in flax_path else 1


def port_spec(flax_spec: tuple, perm: tuple[int, ...], flax_path: str = "") -> Spec:
    axes = {name: perm[i] for i, name in enumerate(flax_spec) if name is not None}
    model = axes.get("model")
    return Spec(axes.get("data"), model, _blocks(flax_path) if model is not None else 1)


@dataclass(frozen=True)
class LeafSharding:
    flax_path: str
    flax_spec: tuple   # leaf_spec's answer on the flax path and shape
    spec: Spec         # the same split on the port tensor's axes


@dataclass
class StateShardings:
    """The split of every leaf of a train state, keyed by the port's names:
    ``model.<parameter or buffer>``, ``optimizer.<moment>.<parameter>``
    (flax path ``opt_state/<mu|nu|trace>/...``), ``optimizer.count``."""

    mode: str
    n_data: int
    n_model: int
    leaves: dict[str, LeafSharding]

    def param(self, name: str) -> Spec:
        return self.leaves[f"model.{name}"].spec


_OPTAX_MOMENTS = {"exp_avg": "mu", "exp_avg_sq": "nu", "momentum_buffer": "trace"}


def state_shardings(mesh: Mesh, state, mode: str = "ddp") -> StateShardings:
    """The rules applied to ``state`` (train/step.py::TrainState, whole or
    already sharded: the full shapes are read)."""
    n_data, n_model = mesh.shape["data"], mesh.shape["model"]
    layout = getattr(state, "layout", None)
    full = dict(zip(layout.names, layout.shapes)) if layout is not None else {}
    model = state.model
    leaves: dict[str, LeafSharding] = {}

    def add(key: str, path: str, shape, perm):
        fshape = tuple(int(shape[p]) for p in perm)
        fspec = leaf_spec(path, fshape, mode, n_data, n_model) if fshape else ()
        leaves[key] = LeafSharding(path, fspec, port_spec(fspec, perm, path))

    for name, p in model.named_parameters():
        shape = full.get(name, p.shape)
        path, perm = flax_leaf(model, name, len(shape))
        add(f"model.{name}", path, shape, perm)
        for moment in state.optimizer.moments:
            add(f"optimizer.{moment}.{name}", f"opt_state/{_OPTAX_MOMENTS[moment]}/{path[len('params/'):]}",
                shape, perm)
    for name, b in model.named_buffers():
        path, perm = flax_leaf(model, name, b.ndim)
        add(f"model.{name}", path, b.shape, perm)
    leaves["optimizer.count"] = LeafSharding("opt_state/count", (), Spec())
    return StateShardings(mode, n_data, n_model, leaves)


# ---------------------------------------------------------------- the sharded state


def model_part(t: torch.Tensor, spec: Spec, n: int, index: int) -> torch.Tensor:
    """Model rank ``index``'s part of ``t`` along the model axis: its
    chunk of each of the axis's ``blocks``."""
    a, b = spec.model, spec.blocks
    t = t.unflatten(a, (b, t.shape[a] // b)).chunk(n, dim=a + 1)[index]
    return t.flatten(a, a + 1)


def shard_of(full: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's part of a whole tensor (a copy)."""
    t = full
    if spec.data is not None:
        t = t.chunk(mesh.n_data, dim=spec.data)[mesh.data_index]
    if spec.model is not None:
        t = model_part(t, spec, mesh.n_model, mesh.model_index)
    return t.contiguous().clone() if t is full else t.contiguous()


def _chunk_range(d: int, n: int, i: int) -> tuple[int, int]:
    """``torch.chunk(n)``'s piece ``i`` of an axis of ``d``."""
    size = -(-d // n)
    return min(i * size, d), min((i + 1) * size, d)


def shard_ranges(shape, spec: Spec, mesh: Mesh) -> list[list[tuple[int, int]]]:
    """The indices ``shard_of`` takes of a whole tensor of ``shape``: per
    axis, ascending (start, stop) ranges (the model axis one per block)."""
    out = [[(0, int(d))] for d in shape]
    if spec.data is not None:
        out[spec.data] = [_chunk_range(int(shape[spec.data]), mesh.n_data, mesh.data_index)]
    if spec.model is not None:
        size = int(shape[spec.model]) // spec.blocks
        lo, hi = _chunk_range(size, mesh.n_model, mesh.model_index)
        out[spec.model] = [(j * size + lo, j * size + hi) for j in range(spec.blocks)]
    return out


def flax_ranges(model: nn.Module, name: str, shape, spec: Spec, mesh: Mesh) -> tuple[str, list]:
    """(flax path, ``shard_ranges`` on the flax leaf's axes) of the port
    parameter ``name`` of whole ``shape``: the part of the JAX package's
    leaf that this rank's shard is made from."""
    path, perm = flax_leaf(model, name, len(shape))
    port = shard_ranges(shape, spec, mesh)
    module = type(model.get_submodule(name.rpartition(".")[0])).__name__
    flipped = _FLIPPED.get(module, ()) if path.endswith("/kernel") else ()
    ranges = []
    for i, p in enumerate(perm):
        d = int(shape[p])
        ranges.append([(d - b, d - a) for a, b in reversed(port[p])] if i in flipped else port[p])
    return path, ranges


def join_model_parts(parts: torch.Tensor, spec: Spec, n: int) -> torch.Tensor:
    """The inverse of ``model_part``: ``parts`` holds the n ranks' parts
    one after another along the model axis."""
    a, b = spec.model, spec.blocks
    t = parts.unflatten(a, (n, b, parts.shape[a] // (n * b))).transpose(a, a + 1)
    return t.flatten(a, a + 2).contiguous()


def gather_full(local: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from every rank's part (a collective)."""
    t = local
    if spec.model is not None:
        t = join_model_parts(gather_axis(t, spec.model, mesh.model_group), spec, mesh.n_model)
    if spec.data is not None:
        t = gather_axis(t, spec.data, mesh.data_group)
    return t


@dataclass(eq=False)
class ShardLayout:
    """What ``shard_state`` attaches to a state: per trainable parameter
    (in ``model.parameters()`` order) its name, split, whole shape and the
    rank's tensor (its shard, or the module's parameter), and the flat
    buckets that hold the replicated parameters' gradients."""

    mesh: Mesh
    shardings: StateShardings
    names: list[str]
    specs: list[Spec]
    shapes: list[torch.Size]
    local: list[torch.Tensor]
    buckets: list[torch.Tensor]

    def split(self):
        """(name, spec, local tensor) of each split parameter."""
        return [(n, s, t) for n, s, t in zip(self.names, self.specs, self.local) if s.split]


    def held_bytes(self, optimizer) -> dict[str, int]:
        """Bytes this rank holds: parameters, optimizer moments, gradients."""
        nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
        return {"params": nbytes(self.local), "moments": nbytes(t for m in optimizer.moments.values() for t in m),
                "grads": nbytes(optimizer.grads)}


BUCKET_BYTES = 1 << 26


def _bucket_views(tensors: list[torch.Tensor], cap: int = BUCKET_BYTES):
    """Flat fp32 buffers of about ``cap`` bytes and, per tensor, a view of
    its place in one of them holding its values."""
    buckets, views, group = [], [], []

    def close():
        flat = torch.empty(sum(t.numel() for t in group), dtype=group[0].dtype, device=group[0].device)
        at = 0
        for t in group:
            v = flat[at:at + t.numel()].view(t.shape)
            v.copy_(t)
            views.append(v)
            at += t.numel()
        buckets.append(flat)
        group.clear()

    size = 0
    for t in tensors:
        if group and size + t.numel() * t.element_size() > cap:
            close()
            size = 0
        group.append(t)
        size += t.numel() * t.element_size()
    if group:
        close()
    return buckets, views


@torch.no_grad()
def shard_state(state, mesh: Mesh, mode: str = "ddp"):
    """Lay ``state`` (whole and identical on every rank) out over ``mesh``
    as ``mode`` says, in place, and return it: each split parameter's
    module tensor becomes an empty placeholder and the rank keeps its
    shard; the optimizer is rebuilt on the rank's tensors with its moments,
    counters and (mid-accumulation) gradients carried over (the whole
    gradient of a leaf not split over 'data' stays on data rank 0 only,
    since the update sums the data ranks' gradients)."""
    if getattr(state, "layout", None) is not None:
        raise ValueError("the state is already sharded")
    if mode not in MODES:
        raise ValueError(f"unknown parallel mode {mode!r}; one of {MODES}")
    shardings = state_shardings(mesh, state, mode)
    old = state.optimizer
    saved = old.state_dict()
    names, specs, shapes, local = [], [], [], []
    named = [(n, p) for n, p in state.model.named_parameters() if p.requires_grad]
    for name, p in named:
        spec = shardings.param(name)
        names.append(name)
        specs.append(spec)
        shapes.append(p.shape)
        if spec.split:
            t = nn.Parameter(shard_of(p.detach(), spec, mesh))
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)
        else:
            t = p
        local.append(t)
    state.optimizer = opt = old.spec.init(local)
    del old
    opt.load_state_dict(local_optimizer_state(saved, specs, mesh))
    replicated = [i for i, s in enumerate(specs) if s.data is None]  # reduced over 'data' at the update
    buckets, views = _bucket_views([opt.grads[i] for i in replicated])
    for i, v in zip(replicated, views):
        opt.grads[i] = v
    opt.adopt_grads()
    state.layout = ShardLayout(mesh, shardings, names, specs, shapes, local, buckets)
    return state


def local_optimizer_state(saved: dict, specs: list[Spec], mesh: Mesh) -> dict:
    """A whole optimizer state (``Optimizer.state_dict``'s layout, as one
    device saves it) cut to this rank's tensors."""
    grads = saved.get("grads")
    if grads is not None:
        grads = [
            shard_of(g, s, mesh) if s.data is not None or mesh.data_index == 0
            else torch.zeros_like(shard_of(g, s, mesh))
            for g, s in zip(grads, specs)
        ]
    moments = {
        i: {k: shard_of(v, specs[int(i)], mesh) for k, v in m.items()}
        for i, m in saved["optimizer"]["state"].items()
    }
    return {**saved, "optimizer": {"state": moments}, "grads": grads}


def full_state_dict(state) -> dict[str, torch.Tensor]:
    """The model's whole state dict (split parameters gathered; a
    collective on a sharded state)."""
    sd = state.model.state_dict()
    layout = getattr(state, "layout", None)
    if layout is not None:
        for name, spec, t in layout.split():
            sd[name] = gather_full(t.detach(), spec, layout.mesh)
    return sd


def full_optimizer_state(state) -> dict:
    """``Optimizer.state_dict`` of the whole state, as one device would
    write it: split moments gathered; mid-accumulation, each gradient not
    split over 'data' summed over the data group, and split ones gathered
    (a collective on a sharded state)."""
    saved = state.optimizer.state_dict()
    layout = getattr(state, "layout", None)
    if layout is None:
        return saved
    mesh, specs = layout.mesh, layout.specs
    moments = {
        i: {k: gather_full(v, specs[i], mesh) if specs[i].split else v for k, v in m.items()}
        for i, m in saved["optimizer"]["state"].items()
    }
    grads = saved["grads"]
    if grads is not None:
        summed = lambda g, s: all_reduce_(g.clone(), mesh.data_group) if s.data is None and mesh.data_group else g
        grads = [gather_full(summed(g, s), s, mesh) if s.split else summed(g, s) for g, s in zip(grads, specs)]
    return {**saved, "optimizer": {"state": moments}, "grads": grads}
