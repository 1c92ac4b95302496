"""Bilinear feature warp by flow: a CUDA kernel on the card, plain PyTorch
on the CPU.

Counterpart of picopose_tpu/ops/sample.py:64-127 (``warp_by_flow``) with
the sample done by ``kernels/csrc/warp.cu``, which replaces
picopose_tpu/ops/pallas/warp.py::warp_pallas: a 4-tap gather per output
pixel, bound by bytes (at the 64^2 level 34 MB of source in, 168 MB out).

Semantics (both versions): sample source map b // group at the (x, y)
pixel coordinates cen[b, p] in align_corners=True pixel space, zero
padding.  Each of the four weights wy*wx is formed in fp32 and rounded to
the feature dtype, the products are summed in fp32 and the output is
rounded once, as the TPU kernel does; in fp32 this is the JAX package's
gather path (``_warp_by_flow_xla``) up to summation order.

Gradients (ops/vjp.py): ``warp_by_flow`` is differentiable in the features
and the flow through an autograd Function whose backward recomputes
``warp_by_flow_reference``, the port's copy of
picopose_tpu/ops/sample.py::_warp_by_flow_xla (the JAX custom_vjp's
backward form).  That form lerps in x then in y in the feature dtype, so in
bf16 the plain version cannot serve.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from picopose_tpu_torch import kernels
from picopose_tpu_torch.geom.grids import pixel_coords_grid
from picopose_tpu_torch.ops.vjp import needs_grad, recompute_grads


def _taps(cen: torch.Tensor, H: int, W: int, pad: int):
    """floor, fraction and clamped integer corner of (..., 2) centres; the
    corner is clamped to [-pad, size + pad - 1] before it becomes an
    integer, so a centre far off the map stays off it."""
    lo = torch.floor(cen)
    frac = cen - lo
    x0 = lo[..., 0].clamp(-pad, W + pad - 1).long()
    y0 = lo[..., 1].clamp(-pad, H + pad - 1).long()
    return x0, y0, frac[..., 0], frac[..., 1]


def _gather_rows(src: torch.Tensor, b2: torch.Tensor, yy, xx, H: int, W: int):
    """Rows src[b2, yy*W + xx] of a (B2, H*W, C) map, zero outside the map,
    without expanding the map to the streams' batch."""
    ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
    idx = b2 * (H * W) + torch.where(ok, yy * W + xx, torch.zeros_like(yy))
    rows = src.reshape(-1, src.shape[-1])[idx.reshape(-1)].reshape(*idx.shape, -1)
    return rows, ok


def warp_plain(feat: torch.Tensor, cen: torch.Tensor, H: int, W: int, group: int = 1) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch ops: feat (B/group, H*W, C),
    cen (B, P, 2) fp32 -> (B, P, C) in feat's dtype."""
    B, P = cen.shape[:2]
    b2 = (torch.arange(B, device=cen.device) // group)[:, None]
    x0, y0, fx, fy = _taps(cen.float(), H, W, 2)
    acc = torch.zeros((B, P, feat.shape[-1]), dtype=torch.float32, device=feat.device)
    for dy in (0, 1):
        for dx in (0, 1):
            w = ((fy if dy else 1.0 - fy) * (fx if dx else 1.0 - fx)).to(feat.dtype).float()
            rows, ok = _gather_rows(feat, b2, y0 + dy, x0 + dx, H, W)
            acc = acc + torch.where(ok, w, torch.zeros_like(w))[..., None] * rows.float()
    return acc.to(feat.dtype)


def warp_cuda(feat: torch.Tensor, cen: torch.Tensor, H: int, W: int, group: int = 1) -> torch.Tensor:
    """Launch the CUDA kernel: feat (B/group, H*W, C) bf16 or fp32 with C a
    multiple of 16 bytes, cen (B, P, 2)."""
    if not (feat.is_cuda and cen.is_cuda):
        raise ValueError("warp_cuda takes CUDA tensors")
    if feat.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"warp kernel takes fp32 or bf16 features, got {feat.dtype}")
    B2, Q, C = feat.shape
    B, P = cen.shape[:2]
    if Q != H * W or cen.shape[2] != 2 or B != B2 * group:
        raise ValueError(f"shapes must be feat (B/group, H*W, C), cen (B, P, 2); got {tuple(feat.shape)}, {tuple(cen.shape)}")
    if (C * feat.element_size()) % 16:
        raise ValueError(f"warp kernel takes rows of whole 16-byte vectors, got C = {C}")
    feat = kernels.contiguous_aligned(feat, 16)
    cen = cen.to(torch.float32).contiguous()
    out = torch.empty((B, P, C), dtype=feat.dtype, device=feat.device)
    if out.numel() == 0:
        return out
    with kernels.on_device_of(feat):
        kernels.launch(
            "warp", feat.data_ptr(), cen.data_ptr(), out.data_ptr(), B, P, H, W,
            C, group, int(feat.dtype == torch.bfloat16), kernels.stream_of(feat),
        )
    return out


def warp(feat: torch.Tensor, cen: torch.Tensor, H: int, W: int, group: int = 1) -> torch.Tensor:
    """(B, P, C) bilinear sample: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if feat.device.type == "cpu":
        return warp_plain(feat, cen, H, W, group)
    return warp_cuda(feat, cen, H, W, group)


def warp_by_flow_reference(feat: torch.Tensor, flow: torch.Tensor, group: int = 1) -> torch.Tensor:
    """``_warp_by_flow_xla`` (``bilinear_sample`` at the pixel grid plus
    flow): weights rounded to the feature dtype, the four taps lerped in x,
    then in y, in that dtype; the backward's form."""
    B2, H, W, C = feat.shape
    grid = pixel_coords_grid(H, W, device=flow.device) + flow.float()
    x, y = grid[..., 0], grid[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0).to(feat.dtype)[..., None], (y - y0).to(feat.dtype)[..., None]
    b2 = (torch.arange(flow.shape[0], device=feat.device) // group)[:, None, None]

    def tap(yi, xi):
        ok = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        v = feat[b2, yi.clamp(0, H - 1).long(), xi.clamp(0, W - 1).long()]
        return v * ok[..., None].to(feat.dtype)

    top = tap(y0, x0) * (1 - wx) + tap(y0, x0 + 1) * wx
    bot = tap(y0 + 1, x0) * (1 - wx) + tap(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def _warp_by_flow(feat, flow, group):
    B2, H, W, C = feat.shape
    B = flow.shape[0]
    grid = pixel_coords_grid(H, W, device=flow.device) + flow.float()
    out = warp(feat.reshape(B2, H * W, C), grid.reshape(B, H * W, 2), H, W, group)
    return out.reshape(B, H, W, C)


class _WarpByFlow(torch.autograd.Function):
    """The kernel forward; the backward through ``warp_by_flow_reference``."""

    @staticmethod
    def forward(ctx, feat, flow, group):
        ctx.save_for_backward(feat, flow)
        ctx.group = group
        return _warp_by_flow(feat, flow, group)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return (*recompute_grads(ctx, warp_by_flow_reference, g, ctx.group), None)


def warp_by_flow(feat: torch.Tensor, flow: torch.Tensor, group: int = 1) -> torch.Tensor:
    """Warp (B/group, H, W, C) ``feat`` by (B, H, W, 2) ``flow``:
    out[b, p] = feat[b // group] sampled at p + flow[b, p]; one launch.
    Differentiable in ``feat`` and ``flow``."""
    if flow.shape[0] != feat.shape[0] * group:
        raise ValueError(f"flow batch {flow.shape[0]} is not {group} x the feature batch {feat.shape[0]}")
    if needs_grad(feat, flow):
        return _WarpByFlow.apply(feat, flow, group)
    return _warp_by_flow(feat, flow, group)
