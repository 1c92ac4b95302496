"""Gradients through the kernels, as the JAX package takes them.

picopose_tpu wraps four of its Pallas kernels in ``jax.custom_vjp``s whose
backward recomputes the function through its XLA form and differentiates
that: LayerNorm (ops/layernorm.py:37-56, ``layernorm_xla``), attention
(ops/attention.py:34-55, ``attention_xla``), the correlation lookup
(ops/corr.py:249-276, ``_corr_lookup_xla``, every level with its pooling)
and the warp (ops/sample.py:87-106, ``_warp_by_flow_xla``).  The TPU
kernels have no backward of their own, so neither do the port's.

Each of the port's four modules has a ``torch.autograd.Function`` at the
level of the JAX ``custom_vjp``.  Its forward is the kernel on CUDA tensors
and the plain version on CPU tensors, the same call as without autograd,
and it saves only its inputs.  Its backward recomputes the module's
``*_reference`` (the port's copy of the JAX form, bf16 rounding points
included) under grad mode and returns ``torch.autograd.grad`` of it.  The
same Function runs on both devices, so the CPU tests reach the backward
that the card runs.  The wrappers enter it only when ``needs_grad``:
otherwise they call the forward directly and the inference path's host
time and launch counts do not move.
"""

from __future__ import annotations

import torch

from picopose_tpu_torch.device import full_fp32


def index_select(x: torch.Tensor, dim: int, index: torch.Tensor) -> torch.Tensor:
    """``x.index_select(dim, index)`` (``dim`` >= 0) with a backward whose
    sums run in a fixed order on either device, so that two identical
    training steps give bitwise equal gradients.  On the CPU that is
    ``index_select`` itself: its backward, ``index_add_``, adds serially
    there.  On CUDA ``index_add_`` adds atomically, in an order that
    changes from run to run; advanced indexing's backward (``index_put_``
    with accumulate) sorts the indices and sums each run of equal ones in
    turn, with no host sync.  The forward is the same gather either way."""
    if x.device.type == "cpu":
        return x.index_select(dim, index)
    return x[(slice(None),) * dim + (index,)]


def needs_grad(*tensors: torch.Tensor) -> bool:
    """True when autograd would record an op on ``tensors``: grad mode is on
    and one of them requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def recompute_grads(ctx, reference, grad_out: torch.Tensor, *static) -> tuple:
    """The backward of a kernel Function: gradients of
    ``reference(*saved, *static)`` for the cotangent ``grad_out`` with
    respect to the saved inputs that need them (None for the others), in
    the order the inputs were saved.  The recompute runs under
    ``full_fp32``, as the forward's fp32 work does."""
    saved = ctx.saved_tensors
    needs = ctx.needs_input_grad[: len(saved)]
    with torch.enable_grad(), full_fp32():
        xs = [x.detach().requires_grad_(n) for x, n in zip(saved, needs)]
        out = reference(*xs, *static)
        grads = iter(torch.autograd.grad(out, [x for x, n in zip(xs, needs) if n], grad_out))
    return tuple(next(grads) if n else None for n in needs)
