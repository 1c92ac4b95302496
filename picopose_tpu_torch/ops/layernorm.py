"""LayerNorm over the last axis: a CUDA kernel on the card, plain PyTorch on the CPU.

Replaces picopose_tpu/ops/pallas/layernorm.py::layernorm_pallas (the ViT
trunk's 48 LNs per forward).  The kernel is ``kernels/csrc/layernorm.cu``:
one warp per token row, 8 rows per block, bound by bytes (a (16, 257,
1024) bf16 stream is 16.8 MB in and out, ~5 us at 3.35 TB/s).  At the ViT
widths (models/dinov2.py::VIT_CONFIGS: 128, 384, 768, 1024, 1536) each lane
keeps its share of the row in registers,
so x is read once and y written once in 16-byte vectors; any other C that
is a multiple of 16 bytes takes a loop that reads the row twice.

Semantics (both versions): fp32 sums of x and of x*x with the square taken
in x's dtype, var = max(E[x^2] - E[x]^2, 0), fp32 affine with fp32
scale/bias, output in x's dtype.

Gradients (ops/vjp.py): ``layernorm`` is differentiable through an
autograd Function whose backward recomputes ``layernorm_reference``, the
port's copy of picopose_tpu/ops/layernorm.py::layernorm_xla (the JAX
custom_vjp's backward form).  It squares in fp32, where the kernel and its
plain version square in x's dtype, so in bf16 the plain version cannot
serve; in fp32 the two agree up to summation order.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from picopose_tpu_torch import kernels
from picopose_tpu_torch.ops.vjp import needs_grad, recompute_grads

def layernorm_plain(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch ops."""
    inv_c = 1.0 / x.shape[-1]
    xf = x.float()
    mean = xf.sum(-1, keepdim=True) * inv_c
    mean_sq = (x * x).float().sum(-1, keepdim=True) * inv_c
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    y = (xf - mean) * (inv * scale.float()) + bias.float()
    return y.to(x.dtype)


def layernorm_reference(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """``layernorm_xla``: fp32 statistics of the fp32 row (its square in
    fp32), the backward's form."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
    y = (xf - mean) * (torch.rsqrt(var + eps) * scale.float()) + bias.float()
    return y.to(x.dtype)


def check_width(C: int, dtype: torch.dtype) -> None:
    """Raise unless the kernel takes rows of C elements of ``dtype``: C must
    fill whole 16-byte vectors."""
    vec = 16 // dtype.itemsize
    if C <= 0 or C % vec:
        raise ValueError(f"layernorm kernel takes C a multiple of {vec} for {dtype}, got {C}")


def _f32_vector(p: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``p`` as a contiguous fp32 vector on ``like``'s device, 16-byte aligned
    for the kernel's float4 loads (``p`` itself when it already is)."""
    if (p.dtype == torch.float32 and p.get_device() == like.get_device() and p.is_contiguous()
            and p.data_ptr() % 16 == 0):
        return p
    return kernels.contiguous_aligned(p.to(device=like.device, dtype=torch.float32), 16)


def layernorm_cuda(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """Launch the CUDA kernel on a (..., C) CUDA tensor in fp32 or bf16."""
    if not x.is_cuda:
        raise ValueError("layernorm_cuda takes a CUDA tensor")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"layernorm kernel takes fp32 or bf16, got {x.dtype}")
    C = x.shape[-1]
    if scale.shape != (C,) or bias.shape != (C,):
        raise ValueError(f"scale/bias must be ({C},)")
    check_width(C, x.dtype)
    if not x.is_contiguous() or x.data_ptr() % 16:
        x = kernels.contiguous_aligned(x, 16)
    scale, bias = _f32_vector(scale, x), _f32_vector(bias, x)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    with kernels.on_device_of(x):
        kernels.launch(
            "layernorm", x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            y.data_ptr(), x.numel() // C, C, eps,
            int(x.dtype == torch.bfloat16), kernels.stream_of(x),
        )
    return y


def _layernorm(x, scale, bias, eps):
    if x.device.type == "cpu":
        return layernorm_plain(x, scale, bias, eps)
    return layernorm_cuda(x, scale, bias, eps)


class _LayerNorm(torch.autograd.Function):
    """The kernel forward; the backward through ``layernorm_reference``."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale, bias)
        ctx.eps = eps
        return _layernorm(x, scale, bias, eps)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return (*recompute_grads(ctx, layernorm_reference, g, ctx.eps), None)


def layernorm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """(..., C) LayerNorm: the kernel for CUDA tensors, the plain version
    for CPU tensors; differentiable in x, scale and bias."""
    if needs_grad(x, scale, bias):
        return _LayerNorm.apply(x, scale, bias, eps)
    return _layernorm(x, scale, bias, eps)
