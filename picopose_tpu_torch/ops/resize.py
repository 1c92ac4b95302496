"""Torch-semantics image resizing on NHWC (or NHW) tensors.

Counterpart of picopose_tpu/ops/resize.py:30-85, written as gather + lerp
so the rounding matches the JAX package (the lerp runs in the input's
dtype) rather than ``F.interpolate``'s fp32 internal math:

  * nearest: src = floor(dst * in/out) (mask downsampling);
  * bilinear, align_corners=True: src = dst * (in-1)/(out-1) (DPT fusion,
    flow and certainty upsampling);
  * 2x2 average pooling (the correlation pyramid).

The gathers go through ``ops/vjp.py::index_select``, whose backward adds
in a fixed order on the card too (the training step's repeatability).
"""

from __future__ import annotations

import torch

from picopose_tpu_torch.ops.vjp import index_select


def resize_nearest(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """(B, H, W, ...) nearest resize with F.interpolate('nearest') index math."""
    H, W = x.shape[1], x.shape[2]
    oh, ow = out_hw
    f32 = dict(dtype=torch.float32, device=x.device)
    ih = torch.floor(torch.arange(oh, **f32) * (H / oh)).long()
    iw = torch.floor(torch.arange(ow, **f32) * (W / ow)).long()
    return index_select(index_select(x, 1, ih), 2, iw)


def _linear_weights(out_size: int, in_size: int, device):
    f32 = dict(dtype=torch.float32, device=device)
    if out_size > 1:
        src = torch.arange(out_size, **f32) * ((in_size - 1) / (out_size - 1))
    else:
        src = torch.zeros((out_size,), **f32)
    src = torch.clamp(src, 0.0, in_size - 1)
    lo = torch.floor(src).long()
    hi = torch.clamp(lo + 1, max=in_size - 1)
    return lo, hi, src - lo


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """(B, H, W, ...) bilinear resize with F.interpolate(align_corners=True)
    index math."""
    H, W = x.shape[1], x.shape[2]
    oh, ow = out_hw
    ylo, yhi, wy = _linear_weights(oh, H, x.device)
    xlo, xhi, wx = _linear_weights(ow, W, x.device)

    def lerp(a, b, w, axis):
        shape = [1] * x.ndim
        shape[axis] = -1
        w = w.reshape(shape).to(x.dtype)
        return a * (1 - w) + b * w

    top = lerp(index_select(x, 1, ylo), index_select(x, 1, yhi), wy, 1)
    return lerp(index_select(top, 2, xlo), index_select(top, 2, xhi), wx, 2)


def avg_pool2d(x: torch.Tensor, k: int = 2) -> torch.Tensor:
    """(B, H, W, C) average pool with kernel = stride = k (H, W divisible
    by k).  The mean is taken in fp32 and rounded once to x's dtype, as
    ``jnp.mean`` does for bf16."""
    B, H, W, C = x.shape
    pooled = x.reshape(B, H // k, k, W // k, k, C).float().mean(dim=(2, 4))
    return pooled.to(x.dtype)
