"""LayerNorm over the last axis: a CUDA kernel on the card, plain PyTorch on the CPU.

Replaces picopose_tpu/ops/pallas/layernorm.py::layernorm_pallas (the ViT
trunk's 48 LNs per forward).  The kernel is
``kernels/csrc/layernorm.cu``: one block per token row, bound by bytes
(a (16, 257, 1024) bf16 stream is 16.8 MB in and out, ~5 us at 3.35 TB/s);
it reads each row from device memory once and writes it once.

Semantics (both versions): fp32 sums of x and of x*x with the square taken
in x's dtype, var = max(E[x^2] - E[x]^2, 0), fp32 affine with fp32
scale/bias, output in x's dtype.
"""

from __future__ import annotations

import torch

from picopose_tpu_torch import kernels


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
    x = x.contiguous()
    scale = scale.to(device=x.device, dtype=torch.float32).contiguous()
    bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        kernels.launch(
            "layernorm", x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            y.data_ptr(), x.numel() // C, C, float(eps),
            int(x.dtype == torch.bfloat16), kernels.stream_of(x),
        )
    return y


def layernorm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """(..., C) LayerNorm: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if x.device.type == "cpu":
        return layernorm_plain(x, scale, bias, eps)
    return layernorm_cuda(x, scale, bias, eps)
