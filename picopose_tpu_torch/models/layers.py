"""Layers that keep fp32 parameters and compute in the input's dtype.

The JAX package keeps every parameter in fp32 and casts it to the compute
dtype at the op (flax ``Dense``/``Conv`` with ``dtype=``); these layers do
the same, so a bf16 model rounds each weight exactly where the JAX one
does.  The norms follow flax's arithmetic: fp32 statistics, the variance
as E[x^2] - E[x]^2, and y = (x - mean) * (rsqrt(var + eps) * scale) + bias.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from picopose_tpu_torch.parallel.collectives import all_reduce_shared, data_mesh, from_model_parallel


def _cast(p: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor | None:
    return None if p is None else p.to(dtype)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


def row_parallel(layer: Linear, x: torch.Tensor, mesh) -> torch.Tensor:
    """``layer`` row-parallel over ``mesh``'s model group: this rank's
    input columns, the ranks' partial outputs summed, the bias added once."""
    y = from_model_parallel(F.linear(x, layer.weight.to(x.dtype)), mesh)
    return y + layer.bias.to(y.dtype)


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(
            x, self.weight.to(x.dtype), _cast(self.bias, x.dtype), self.stride,
            self.padding, self.output_padding, self.groups, self.dilation,
        )


class BatchNorm2d(nn.Module):
    """BatchNorm over NCHW with flax's semantics (momentum 0.9).

    In ``.eval()`` it normalises with the running statistics.  In
    ``.train()`` it normalises with the batch's fp32 statistics (the biased
    variance E[x^2] - E[x]^2, clamped at 0; gradients flow through both)
    and moves the running statistics by ``ra = 0.9 ra + 0.1 batch``, the
    variance biased too, where ``nn.BatchNorm2d`` would store the unbiased
    one.  A module called twice in a step (the shared DPT head, each
    level's ``proj_bn``) updates them twice, in call order.

    Inside ``parallel.collectives.data_parallel`` over more than one data
    rank the statistics are the global batch's, as the JAX package's
    sharded step computes them: each rank's sums of x and x^2 are summed
    over the data group (the backward sums the ranks' gradients of them),
    and every rank moves its running statistics by the same global values.
    """

    momentum = 0.9

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = (slice(None), None, None)
        xf = x.float()
        mesh = data_mesh()
        if self.training and mesh is not None:  # the global batch's statistics
            sums = all_reduce_shared(torch.stack([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3))]),
                                     mesh.data_group)
            n = float(mesh.n_data * (xf.numel() // xf.shape[1]))
            mean = sums[0] / n
            var = torch.clamp(sums[1] / n - mean * mean, min=0.0)
        elif self.training:
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        if self.training:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[c]) * mul[c] + self.bias[c]
        return y.to(x.dtype)


class GroupNorm(nn.Module):
    """GroupNorm over NCHW with flax's fast-variance statistics."""

    def __init__(self, groups: int, channels: int, eps: float = 1e-5):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        G = self.groups
        xg = x.float().reshape(B, G, C // G, H, W)
        mean = xg.mean(dim=(2, 3, 4), keepdim=True)
        var = torch.clamp((xg * xg).mean(dim=(2, 3, 4), keepdim=True) - mean * mean, min=0.0)
        shape = (1, G, C // G, 1, 1)
        mul = torch.rsqrt(var + self.eps) * self.weight.reshape(shape)
        y = (xg - mean) * mul + self.bias.reshape(shape)
        return y.reshape(B, C, H, W).to(x.dtype)
