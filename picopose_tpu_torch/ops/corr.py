"""RAFT-style windowed correlation lookup: a CUDA kernel on the card, plain
PyTorch on the CPU.

Counterpart of picopose_tpu/ops/corr.py (``_corr_lookup_pallas_impl``,
:202-246), which calls picopose_tpu/ops/pallas/corr.py::corr_window_pallas
once per pyramid level; here up to four levels of one lookup are one
launch of ``kernels/csrc/corr.cu`` (the flow decoder's lookups, 1 to 3
levels, are one launch each), which reads feat1 once and writes its
levels' channels of the concatenated (B, H, W, L*(2r+1)^2) output.  Any
lookup radius r >= 0: the kernel is templated on r from 1 to 4 and has a
runtime-radius form for the others.  Avg pooling and bilinear
sampling are both linear in feat2, so level i's correlation is
<feat1[p], avgpool_i(feat2)[q]> / sqrt(C): feat2 is pooled between levels
outside the kernel, and only the (2r+2)^2 cells each bilinear window
touches are computed (bf16: tiles of 8 x 8 pixels against a box of cells
on the tensor cores, per pixel where a window leaves the box).

Semantics (both versions): the dot products are summed in fp32 and scaled
by C^-0.5, a cell outside the map is 0, the (2r+1)^2 taps are lerped in y
then in x in fp32 and rounded once to feat1's dtype (the TPU kernel's
rounding; the JAX package's XLA path rounds the correlation to the feature
dtype first, so in bf16 the two differ).  Channel order is the
reference's: k = kx*(2r+1) + ky, the outer window index walks x.

Gradients (ops/vjp.py): ``corr_lookup`` is differentiable in both feature
maps and the flow through an autograd Function whose backward recomputes
``corr_lookup_reference``, the port's copy of
picopose_tpu/ops/corr.py::_corr_lookup_xla (the JAX custom_vjp's backward
form, every level with its pooling).  That form rounds the correlation and
each lerp to the feature dtype, so in bf16 the plain version cannot serve.
"""

from __future__ import annotations

import math
import struct

import torch
from torch.autograd.function import once_differentiable

from picopose_tpu_torch import kernels
from picopose_tpu_torch.geom.grids import pixel_coords_grid
from picopose_tpu_torch.ops.resize import avg_pool2d
from picopose_tpu_torch.ops.sample import _gather_rows, _taps
from picopose_tpu_torch.ops.vjp import needs_grad, recompute_grads


def corr_window_plain(
    f1: torch.Tensor, f2: torch.Tensor, cen: torch.Tensor, Hp: int, Wp: int,
    radius: int, group: int = 1,
) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch ops: f1 (B, P, C), f2
    (B/group, Hp*Wp, C), cen (B, P, 2) -> (B, P, (2r+1)^2) in f1's dtype.
    Loops over the (2r+2)^2 cells, so no (B, P, cells, C) gather exists."""
    B, P, C = f1.shape
    n, m = 2 * radius + 1, 2 * radius + 2
    b2 = (torch.arange(B, device=f1.device) // group)[:, None]
    x0, y0, fx, fy = _taps(cen.float(), Hp, Wp, radius + 2)
    x0, y0 = x0 - radius, y0 - radius
    a = f1.float()
    cell = {}
    for dy in range(m):
        for dx in range(m):
            rows, ok = _gather_rows(f2, b2, y0 + dy, x0 + dx, Hp, Wp)
            dot = (a * rows.float()).sum(-1) * (float(C) ** -0.5)
            cell[dy, dx] = torch.where(ok, dot, torch.zeros_like(dot))
    taps = []
    for kx in range(n):
        for ky in range(n):
            r0 = (1.0 - fy) * cell[ky, kx] + fy * cell[ky + 1, kx]
            r1 = (1.0 - fy) * cell[ky, kx + 1] + fy * cell[ky + 1, kx + 1]
            taps.append((1.0 - fx) * r0 + fx * r1)
    return torch.stack(taps, dim=-1).to(f1.dtype)


def _level_windows(f1, maps, grid, radius, group):
    """Shapes of a multi-level lookup: f1 (B, H, W, C), maps [(f2 (B/group,
    Hp, Wp, C), shift)], grid (B, H, W, 2) level-0 centres."""
    B, H, W, C = f1.shape
    if grid.shape != (B, H, W, 2):
        raise ValueError(f"centres must be (B, H, W, 2) = {(B, H, W, 2)}, got {tuple(grid.shape)}")
    for f2, _ in maps:
        if f2.ndim != 4 or f2.shape[3] != C or f2.shape[0] * group != B:
            raise ValueError(
                f"each map must be (B/group, Hp, Wp, C) with B = {B}, group = {group}, C = {C}; "
                f"got {tuple(f2.shape)}"
            )
    return B, H, W, C, (2 * radius + 1) ** 2


def corr_windows_plain(
    f1: torch.Tensor, maps, grid: torch.Tensor, radius: int, group: int = 1
) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch ops, level by level: f1 (B, H, W,
    C), maps [(f2 (B/group, Hp, Wp, C), shift)], grid (B, H, W, 2) level-0
    centres -> (B, H, W, L*(2r+1)^2) in f1's dtype; level i samples its map
    at grid / 2^shift_i into channels [i*(2r+1)^2, (i+1)*(2r+1)^2)."""
    B, H, W, C, nn = _level_windows(f1, maps, grid, radius, group)
    out = torch.empty((B, H, W, len(maps) * nn), dtype=f1.dtype, device=f1.device)
    a, cen = f1.reshape(B, H * W, C), grid.float().reshape(B, H * W, 2)
    for i, (f2, shift) in enumerate(maps):
        Hp, Wp = f2.shape[1:3]
        win = corr_window_plain(a, f2.reshape(-1, Hp * Wp, C), cen / 2.0**shift, Hp, Wp, radius, group)
        out[..., i * nn : (i + 1) * nn] = win.reshape(B, H, W, nn)
    return out


LEVELS_PER_LAUNCH = 4  # kMaxLevels of kernels/csrc/corr.cu


def corr_windows_cuda(
    f1: torch.Tensor, maps, grid: torch.Tensor, radius: int, group: int = 1,
    stats: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch the CUDA kernel once per group of up to four levels (once on
    the flow decoder's path): f1 and the maps both bf16 (C a multiple of 64
    up to 256) or both fp32 (C a multiple of 4), any lookup radius >= 0
    (the tile kernel's templates at 1 to 4, a runtime-radius kernel
    otherwise).  ``stats``: None, or an int32 CUDA tensor of 3 that the
    bf16 tile kernel adds its counts to (tile-levels, tile-levels with
    pixels on the per-pixel path, such pixel-levels)."""
    if not (f1.is_cuda and grid.is_cuda and all(f2.is_cuda for f2, _ in maps)):
        raise ValueError("corr_windows_cuda takes CUDA tensors")
    if any(f2.dtype != f1.dtype for f2, _ in maps) or f1.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("corr kernel takes f1 and the maps all bf16 or all fp32")
    B, H, W, C, nn = _level_windows(f1, maps, grid, radius, group)
    bf16 = f1.dtype == torch.bfloat16
    if not maps:
        raise ValueError("corr kernel takes at least one level")
    if (bf16 and (C % 64 or C > 256)) or (not bf16 and C % 4):
        raise ValueError(f"corr kernel takes C a multiple of 64 up to 256 (bf16) or of 4 (fp32), got {C}")
    if not 0 <= radius <= 383:
        raise ValueError(f"corr kernel takes a lookup radius from 0 to 383, got {radius}")
    if stats is not None and (stats.dtype != torch.int32 or stats.numel() != 3 or not stats.is_cuda):
        raise ValueError("stats must be an int32 CUDA tensor of 3")
    f1 = kernels.contiguous_aligned(f1, 16)
    maps = [(kernels.contiguous_aligned(f2, 16), int(shift)) for f2, shift in maps]
    cen = grid.to(torch.float32).contiguous()
    out = torch.empty((B, H, W, len(maps) * nn), dtype=f1.dtype, device=f1.device)
    if out.numel() == 0:
        return out
    with kernels.on_device_of(f1):
        for l0 in range(0, len(maps), LEVELS_PER_LAUNCH):
            part = maps[l0 : l0 + LEVELS_PER_LAUNCH]
            levels = struct.pack(
                f"{4 * len(part)}q", *(v for f2, shift in part for v in (f2.data_ptr(), *f2.shape[1:3], shift))
            )
            kernels.launch(
                "corr_window", f1.data_ptr(), cen.data_ptr(), out.data_ptr(), levels, len(part), l0,
                len(maps), B, H, W, C, radius, group, float(C) ** -0.5, int(bf16),
                None if stats is None else stats.data_ptr(), kernels.stream_of(f1),
            )
    return out


def corr_windows(f1, maps, grid, radius: int, group: int = 1) -> torch.Tensor:
    """All levels of one lookup: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if f1.device.type == "cpu":
        return corr_windows_plain(f1, maps, grid, radius, group)
    return corr_windows_cuda(f1, maps, grid, radius, group)


def corr_lookup_reference(
    feat1: torch.Tensor, feat2: torch.Tensor, flow: torch.Tensor, radius: int,
    num_levels: int, group: int = 1,
) -> torch.Tensor:
    """``_corr_lookup_xla``, the backward's form: per level, the whole
    correlation f1 . pool(f2)^T in the feature dtype times C^-0.5 (rounded
    to that dtype), then the window's bilinear taps: rows lerped in y and
    rounded to the feature dtype, then in x and rounded again (the XLA
    path's two one-hot contractions, fp32 sums of exact products)."""
    B, H, W, C = feat1.shape
    B2, dt, n = feat2.shape[0], feat1.dtype, 2 * radius + 1
    grid = (pixel_coords_grid(H, W, device=flow.device) + flow.float()).reshape(B, H * W, 2)
    f1 = feat1.reshape(B2, group * H * W, C)
    scale = torch.tensor(1.0 / math.sqrt(C), dtype=dt).item()  # rounded to the feature dtype, on the host
    d = torch.arange(n + 1, device=feat1.device)
    outs, pooled = [], feat2
    for i in range(num_levels):
        if i > 0:
            pooled = avg_pool2d(pooled, 2)
        Hp, Wp = pooled.shape[1:3]
        corr = (torch.matmul(f1, pooled.reshape(B2, Hp * Wp, C).transpose(1, 2)) * scale).reshape(B, H * W, -1)
        x0, y0, fx, fy = _taps(grid / 2.0**i, Hp, Wp, radius + 2)
        yy = (y0 - radius)[..., None, None] + d[:, None]  # (B, P, n+1, 1) cell rows
        xx = (x0 - radius)[..., None, None] + d           # (B, P, 1, n+1) cell columns
        ok = (yy >= 0) & (yy < Hp) & (xx >= 0) & (xx < Wp)
        cell = torch.gather(corr, 2, torch.where(ok, yy * Wp + xx, 0).reshape(B, H * W, -1))
        cell = torch.where(ok, cell.reshape(ok.shape), 0.0).float()
        w = lambda f: f.to(dt).float()[..., None, None]  # a lerp weight rounded to the feature dtype
        rows = (w(1.0 - fy) * cell[:, :, :-1] + w(fy) * cell[:, :, 1:]).to(dt).float()  # (B, P, ky, n+1)
        win = (w(1.0 - fx) * rows[..., :-1] + w(fx) * rows[..., 1:]).to(dt)              # (B, P, ky, kx)
        outs.append(win.transpose(-1, -2).reshape(B, H, W, n * n))
    return torch.cat(outs, dim=-1)


def _corr_lookup(feat1, feat2, flow, radius, num_levels, group):
    H, W = feat1.shape[1:3]
    grid = pixel_coords_grid(H, W, device=flow.device) + flow.float()
    maps, pooled = [], feat2
    for i in range(num_levels):
        if i > 0:
            pooled = avg_pool2d(pooled, 2)
        maps.append((pooled, i))
    return corr_windows(feat1, maps, grid, radius, group)


class _CorrLookup(torch.autograd.Function):
    """The kernel forward; the backward through ``corr_lookup_reference``."""

    @staticmethod
    def forward(ctx, feat1, feat2, flow, radius, num_levels, group):
        ctx.save_for_backward(feat1, feat2, flow)
        ctx.static = (radius, num_levels, group)
        return _corr_lookup(feat1, feat2, flow, radius, num_levels, group)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return (*recompute_grads(ctx, corr_lookup_reference, g, *ctx.static), None, None, None)


def corr_lookup(
    feat1: torch.Tensor, feat2: torch.Tensor, flow: torch.Tensor, radius: int,
    num_levels: int, group: int = 1,
) -> torch.Tensor:
    """Windowed correlation lookup over ``num_levels`` pyramid levels.

    feat1 (B, H, W, C) template side, feat2 (B/group, H, W, C) query side
    (each map shared by ``group`` consecutive streams, never repeated),
    flow (B, H, W, 2) in cells, channels (x, y).  Returns
    (B, H, W, L*(2r+1)^2): level i at centres (coords + flow) / 2^i in fp32
    over feat2 avg-pooled i times, all levels in one launch.  Differentiable
    in feat1, feat2 and flow.
    """
    if feat1.shape[0] % feat2.shape[0] != 0:
        raise ValueError(
            f"template batch {feat1.shape[0]} is not a multiple of query batch "
            f"{feat2.shape[0]}; the shared query maps need an integer group"
        )
    if needs_grad(feat1, feat2, flow):
        return _CorrLookup.apply(feat1, feat2, flow, radius, num_levels, group)
    return _corr_lookup(feat1, feat2, flow, radius, num_levels, group)
