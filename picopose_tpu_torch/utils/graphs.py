"""Programs captured as CUDA graphs at fixed shapes, then replayed.

The port's counterpart of what ``jax.jit``'s cache does for the JAX
package's compiled inference programs (``run_batch_jit``, the bank
build's ``feat_fn`` / ``dpt_fn``, ``preprocess_frame``): a program is
keyed by its static arguments and by the shapes and dtypes of its inputs,
as ``jit`` keys on ``static_argnames`` and avals.  A new key captures a
new program; a known key replays.

Capture: one eager warm-up on a side stream first, where first use
happens (``kernels.build`` runs nvcc, the kernels cache the SM count,
cuBLAS and cuDNN set up their handles and workspaces), then the capture
under ``torch.cuda.graph`` in PyTorch's default ``global`` mode.  Every
program of one ``GraphCache`` (an estimator, an eval run) allocates from
one memory pool: they replay one at a time on one stream, so their
intermediates are not held once per program.  A thread that makes CUDA
calls while a capture may be open (the eval runner's pinning thread)
holds ``lock`` around them: the ``global`` mode refuses them otherwise.

Inputs are copied into static buffers with ``copy_`` on the current
stream before each replay.  A *slot* input (a template bank) has one
static slot per signature, shared by every program that takes that
signature, and is copied in only when other tensors come in than the
slot holds: it holds weak references to them, so a bank is taken by
value when it is first seen and treated as immutable after.  Outputs are
cloned after the replay, so two queued calls never alias.

Parameters are baked in by address, as ``jit`` takes ``variables`` by
reference.  The key holds the address and dtype of every parameter and
buffer of the ``module`` a program runs, and its train flag: a module
whose parameters were re-assigned (``precast_inference_params``) is
captured anew, and an in-place copy into them (``load_flax_variables``)
is seen by every replay.  Python-level switches that change what a
program computes (the matching mode, ``quantize_stage3``) are the
caller's static arguments.

State: a program that changes tensors in place (a training step: its
parameters, BatchNorm statistics, gradients and optimizer state) names
them as ``writes``.  The warm-up would change them by one eager call, so
they are cloned before it and copied back after it, in place; their
addresses are in the key, so state swapped under a program (not copied
into) is captured anew.

Random draws: the generator a program draws from is registered with its
graph, so each replay draws from the generator's current state and
advances it, as an eager call does.  The warm-up and the capture leave
the generator's state as they found it.

Launch counts: ``kernels.LAUNCHES`` is left to the kernel wrappers,
which count where a kernel runs: the warm-up's launches count, the
capture's do not (a captured launch runs only at a replay), and a replay
adds nothing, since no wrapper runs then.  What a replay launched shows
in a profiler trace of it, by kernel name.  ``calls``, ``captures`` and
``replays`` count per program name.

On the CPU there are no graphs: ``run`` calls the function.  On CUDA a
failed capture or replay raises; nothing runs eagerly in its place.
"""

from __future__ import annotations

import collections
import threading
import time
import weakref
from typing import Any, Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree


def _signature(leaves: list) -> tuple:
    """Shapes and dtypes of the tensor leaves, the values of the others."""
    return tuple(
        (tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor) else ("value", x) for x in leaves
    )


def _key(name, static, flat_args, flat_slot, generator, module, writes=()) -> tuple:
    """What selects a program: its name, the static arguments, the
    structure, shapes and dtypes of the flattened ``args`` and ``slot``,
    the generator it draws from, the parameters of ``module`` and the
    addresses of ``writes``."""
    return (
        name, static, flat_args[1], _signature(flat_args[0]), _slot_key(flat_slot),
        None if generator is None else id(generator),
        None if module is None else module_key(module),
        tuple(t.data_ptr() for t in writes),
    )


def _slot_key(flat_slot) -> tuple | None:
    return None if flat_slot is None else (flat_slot[1], _signature(flat_slot[0]))


def module_key(module: torch.nn.Module) -> tuple:
    """Address and dtype of every parameter and buffer, and the train flag.

    Read from each submodule's own tables, in one walk of the tree:
    ``parameters()`` and ``buffers()`` walk it twice through generators
    with a memo, host time on every call of a program."""
    tensors = (t for m in module.modules() for d in (m._parameters, m._buffers) for t in d.values())
    return (module.training, *((t.data_ptr(), t.dtype) for t in tensors if t is not None))


class _Buffers:
    """Static tensors standing in for a pytree's tensor leaves."""

    def __init__(self, leaves: list, spec, device: torch.device):
        self.leaves = [
            torch.empty(x.shape, dtype=x.dtype, device=device) if isinstance(x, torch.Tensor) else x
            for x in leaves
        ]
        self.spec = spec
        self.held: list = []  # weak references to the tensors last copied in

    def tree(self):
        return pytree.tree_unflatten(self.leaves, self.spec)

    def load(self, leaves: list) -> None:
        for b, x in zip(self.leaves, leaves):
            if isinstance(b, torch.Tensor):
                b.copy_(x)

    def load_if_new(self, leaves: list) -> bool:
        """Copy ``leaves`` in unless they are the tensors last copied in."""
        tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
        if len(self.held) == len(tensors) and all(r() is x for r, x in zip(self.held, tensors)):
            return False
        self.load(leaves)
        self.held = [weakref.ref(x) for x in tensors]
        return True


class _Program(NamedTuple):
    graph: Any               # torch.cuda.CUDAGraph
    args: _Buffers           # the per-call inputs
    slot: _Buffers | None    # shared with every program of the slot's signature
    outputs: Any             # pytree of the graph's output tensors
    generator: Any           # kept alive: its id is in the key


class GraphCache:
    """The captured programs of one owner, on one device."""

    def __init__(self, device: str | torch.device):
        self.device = torch.device(device)
        self.lock = threading.Lock()
        self.calls: collections.Counter = collections.Counter()
        self.captures: collections.Counter = collections.Counter()
        self.replays: collections.Counter = collections.Counter()
        self.capture_s: dict[str, list[float]] = collections.defaultdict(list)
        self._programs: dict[tuple, _Program] = {}
        self._slots: dict[tuple, _Buffers] = {}
        self._pool = None
        self._stream = None

    def run(
        self,
        name: str,
        fn: Callable,
        args: tuple,
        static: tuple = (),
        slot: Any = None,
        generator: torch.Generator | None = None,
        module: torch.nn.Module | None = None,
        writes: list[torch.Tensor] = (),
    ):
        """``fn(*args)``, or ``fn(*args, slot)`` with a slot: captured at
        the first call of its key, replayed after.  ``args`` and ``slot``
        are pytrees of tensors (and static values); ``static`` holds what
        else selects the program; ``generator`` is the one ``fn`` draws
        from (None: the device's default); ``module`` the one whose
        parameters ``fn`` reads; ``writes`` the tensors it changes in
        place."""
        self.calls[name] += 1
        if self.device.type != "cuda":
            return fn(*args) if slot is None else fn(*args, slot)
        flat_args = pytree.tree_flatten(args)
        flat_slot = None if slot is None else pytree.tree_flatten(slot)
        key = _key(name, static, flat_args, flat_slot, generator, module, writes)
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = self._capture(name, fn, flat_args, flat_slot, generator, writes)
        else:
            prog.args.load(flat_args[0])
            if prog.slot is not None:
                prog.slot.load_if_new(flat_slot[0])
        prog.graph.replay()
        self.replays[name] += 1
        return pytree.tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, prog.outputs)

    def _capture(self, name, fn, flat_args, flat_slot, generator, writes) -> _Program:
        t0 = time.perf_counter()
        args = _Buffers(*flat_args, self.device)
        args.load(flat_args[0])
        slot = None
        if flat_slot is not None:
            slot_key = _slot_key(flat_slot)
            slot = self._slots.get(slot_key)
            if slot is None:
                slot = self._slots[slot_key] = _Buffers(*flat_slot, self.device)
            slot.load_if_new(flat_slot[0])
        call = (lambda: fn(*args.tree())) if slot is None else (lambda: fn(*args.tree(), slot.tree()))
        gen = generator if generator is not None else torch.cuda.default_generators[
            self.device.index if self.device.index is not None else torch.cuda.current_device()]
        state = gen.get_state()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        current = torch.cuda.current_stream(self.device)

        # warm-up: eager, on the side stream; its launches are real, its
        # changes to ``writes`` are undone
        with torch.no_grad():
            before = [t.clone() for t in writes]
        self._stream.wait_stream(current)
        try:
            with torch.cuda.stream(self._stream):
                call()
        finally:
            current.wait_stream(self._stream)
            gen.set_state(state)
            with torch.no_grad():
                for t, b in zip(writes, before):
                    t.copy_(b)
            del before

        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        try:
            with self.lock, torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
                outputs = call()
        finally:
            gen.set_state(state)
        self.captures[name] += 1
        self.capture_s[name].append(time.perf_counter() - t0)
        return _Program(graph, args, slot, outputs, generator)
