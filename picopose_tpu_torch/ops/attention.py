"""Multi-head softmax attention over (B, H, N, D): a CUDA kernel on the card,
plain PyTorch on the CPU.

Replaces picopose_tpu/ops/pallas/flash_attention.py::flash_attention (one
call per ViT block).  The kernel is ``kernels/csrc/attention.cu``: one
block per (batch*head, 64 query rows) with the head's K and V in shared
memory; for bf16 each warp computes 16 query rows with tensor-core
products, recomputing Q K^T per pass (maximum and sum, then P V) so the softmax
sees whole rows before P is rounded; fp32 runs one warp per query row on
the CUDA cores.  Bound by bytes at the main path's (16, 16, 257, 64)
bf16: 33.7 MB moved (~10 us at 3.35 TB/s) against 4.3 GFLOP (~4.4 us on
the bf16 tensor cores).

Semantics (both versions): fp32 scores from storage-dtype operands, the
scale D^-0.5 applied to the fp32 scores, fp32 softmax, P rounded to V's
dtype, P V summed in fp32, output in Q's dtype.  For D = 64 the scale is a
power of two, so this equals scaling Q first; for D = 32 it is not.
"""

from __future__ import annotations

import torch

from picopose_tpu_torch import kernels


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch ops."""
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


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
    q, k, v = (kernels.contiguous_aligned(x) for x in (q, k, v))
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    with torch.cuda.device(q.device):
        kernels.launch(
            "attention", q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B * H, N, D, float(D ** -0.5), int(q.dtype == torch.bfloat16),
            kernels.stream_of(q),
        )
    return o


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, H, N, D) attention: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    return attention_cuda(q, k, v)
