"""Multi-head softmax attention over (B, H, N, D): a CUDA kernel on the card,
plain PyTorch on the CPU.

Replaces picopose_tpu/ops/pallas/flash_attention.py::flash_attention (one
call per ViT block).  The kernels are in ``kernels/csrc/attention.cu``:

- bf16 with N <= 272 (the main path, N = 257): Hopper's wgmma, TMA and
  mbarriers.  It reads q, k and v in place by strides (the ViT passes
  views of its (B, N, 3, H, D) qkv projection) and writes a (B, N, H, D)
  buffer, returned as its (B, H, N, D) transposed view, so the ViT's head
  merge is a view.  Q K^T is computed once per 64-row tile, the score row
  stays in registers, and P is rounded to bf16 once the whole row is
  known.
- bf16 with 272 < N <= 512: the two-pass wmma kernel (Q K^T recomputed
  for the row maximum and sum, then for P V).
- fp32: one warp per query row on the CUDA cores.

The last two take contiguous tensors: for them, and for views whose
strides or alignment TMA cannot take, the wrapper copies q, k and v and
counts the copy in ``INPUT_COPIES`` under its reason.  Bound by bytes at
the main path's (16, 16, 257, 64) bf16: 33.7 MB moved (~10 us at 3.35
TB/s) against 4.3 GFLOP (~4.4 us on the bf16 tensor cores).

Semantics (every version): fp32 scores from storage-dtype operands, the
scale D^-0.5 applied to the fp32 scores, fp32 softmax, P rounded to V's
dtype, P V summed in fp32, output in Q's dtype.  For D = 64 the scale is a
power of two, so this equals scaling Q first; for D = 32 it is not.  The
Hopper kernel takes exp2 with D^-0.5 * log2(e) folded into one FMA and
multiplies by the reciprocal of the row sum; either may move a P element
by one bf16 step against the plain version.

Gradients (ops/vjp.py): ``attention`` is differentiable through an
autograd Function whose backward recomputes ``attention_reference``, the
port's copy of picopose_tpu/ops/attention.py::attention_xla (the JAX
custom_vjp's backward form).  It scales q in q's dtype and rounds the
scores to it before the softmax, where the kernel scales fp32 scores, so
the plain version cannot serve in bf16.
"""

from __future__ import annotations

import collections
import struct

import torch
from torch.autograd.function import once_differentiable

from picopose_tpu_torch import kernels
from picopose_tpu_torch.ops.vjp import needs_grad, recompute_grads

# the longest key row the Hopper kernel holds in registers (hop::kMaxKeys)
HOPPER_MAX_KEYS = 272

# calls whose q, k, v the wrapper had to copy, by reason
INPUT_COPIES: collections.Counter = collections.Counter()


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch ops."""
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``attention_xla``: (q * D^-0.5) K^T in q's dtype, fp32 softmax, P
    rounded to v's dtype, P V in v's dtype; the backward's form."""
    s = torch.matmul(q * q.shape[-1] ** -0.5, k.transpose(-1, -2))
    p = torch.softmax(s.float(), dim=-1).to(v.dtype)
    return torch.matmul(p, v)


def copy_reason(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str | None:
    """None if the Hopper kernel reads (B, H, N, D) q, k, v where they lie;
    else why the wrapper copies them: that kernel takes bf16 with N <= 272
    and TMA takes a contiguous last dim with other strides and the start on
    the 16-byte grid."""
    if q.dtype != torch.bfloat16:
        return "fp32: the CUDA-core kernel takes contiguous tensors"
    if q.shape[2] > HOPPER_MAX_KEYS:
        return f"N > {HOPPER_MAX_KEYS}: the two-pass kernel takes contiguous tensors"
    for t in (q, k, v):
        sb, sh, sn, sd = t.stride()
        if sd != 1 or t.data_ptr() % 16 or sb % 8 or sh % 8 or sn % 8 or min(sb, sh, sn) <= 0:
            return "strides or start off the 16-byte grid TMA needs"
    return None


def attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on (B, H, N, D) CUDA tensors, fp32 or bf16,
    D in {32, 64}, N <= 512."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("attention_cuda takes CUDA tensors")
    if not (q.shape == k.shape == v.shape) or q.ndim != 4:
        raise ValueError(f"q, k, v must share one (B, H, N, D) shape: {q.shape}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("attention kernel takes q, k, v all fp32 or all bf16")
    B, H, N, D = q.shape
    if D not in (32, 64) or N > 512:
        raise ValueError(f"attention kernel takes D in (32, 64) and N <= 512, got {D}, {N}")
    reason = copy_reason(q, k, v)
    if reason is None:
        o = torch.empty(B, N, H, D, dtype=q.dtype, device=q.device).transpose(1, 2)
    else:
        INPUT_COPIES[reason] += 1
        q, k, v = (kernels.contiguous_aligned(x) for x in (q, k, v))
        o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    strides = struct.pack(
        "12q", *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3]
    )
    with kernels.on_device_of(q):
        kernels.launch(
            "attention", q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, H, N, D, strides, D ** -0.5, int(q.dtype == torch.bfloat16),
            kernels.stream_of(q),
        )
    return o


def _attention(q, k, v):
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    return attention_cuda(q, k, v)


class _Attention(torch.autograd.Function):
    """The kernel forward; the backward through ``attention_reference``."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _attention(q, k, v)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return recompute_grads(ctx, attention_reference, g)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, H, N, D) attention: the kernel for CUDA tensors, the plain
    version for CPU tensors; differentiable in q, k and v."""
    if needs_grad(q, k, v):
        return _Attention.apply(q, k, v)
    return _attention(q, k, v)
