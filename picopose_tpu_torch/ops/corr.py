"""RAFT-style windowed correlation lookup: a CUDA kernel on the card, plain
PyTorch on the CPU.

Counterpart of picopose_tpu/ops/corr.py (``_corr_lookup_pallas_impl``,
:202-246) with each pyramid level done by ``kernels/csrc/corr.cu``, which
replaces picopose_tpu/ops/pallas/corr.py::corr_window_pallas.  Avg
pooling and bilinear sampling are both linear in feat2, so level i's
correlation is <feat1[p], avgpool_i(feat2)[q]> / sqrt(C): feat2 is pooled
between levels outside the kernel, and the kernel computes, per pixel,
only the (2r+2)^2 cells its bilinear window touches.

Semantics (both versions): the dot products are summed in fp32 and scaled
by C^-0.5, a cell outside the map is 0, the (2r+1)^2 taps are lerped in y
then in x in fp32 and rounded once to feat1's dtype (the TPU kernel's
rounding; the JAX package's XLA path rounds the correlation to the feature
dtype first, so in bf16 the two differ).  Channel order is the
reference's: k = kx*(2r+1) + ky, the outer window index walks x.
"""

from __future__ import annotations

import torch

from picopose_tpu_torch import kernels
from picopose_tpu_torch.geom.grids import pixel_coords_grid
from picopose_tpu_torch.ops.resize import avg_pool2d
from picopose_tpu_torch.ops.sample import _gather_rows, _taps


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


def corr_window_cuda(
    f1: torch.Tensor, f2: torch.Tensor, cen: torch.Tensor, Hp: int, Wp: int,
    radius: int, group: int = 1,
) -> torch.Tensor:
    """Launch the CUDA kernel: f1 and f2 both bf16 or both fp32 with C a
    multiple of 16 bytes, radius 2 (the flow decoder's)."""
    if not (f1.is_cuda and f2.is_cuda and cen.is_cuda):
        raise ValueError("corr_window_cuda takes CUDA tensors")
    if f1.dtype != f2.dtype or f1.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("corr kernel takes f1 and f2 both bf16 or both fp32")
    B, P, C = f1.shape
    B2, Q = f2.shape[:2]
    if f2.shape[2] != C or Q != Hp * Wp or cen.shape != (B, P, 2) or B != B2 * group:
        raise ValueError(
            f"shapes must be f1 (B, P, C), f2 (B/group, Hp*Wp, C), cen (B, P, 2); "
            f"got {tuple(f1.shape)}, {tuple(f2.shape)}, {tuple(cen.shape)}"
        )
    if (C * f1.element_size()) % 16:
        raise ValueError(f"corr kernel takes rows of whole 16-byte vectors, got C = {C}")
    if radius != 2:
        raise ValueError(f"corr kernel is built for radius 2, got {radius}")
    f1, f2 = kernels.contiguous_aligned(f1, 16), kernels.contiguous_aligned(f2, 16)
    cen = cen.to(torch.float32).contiguous()
    out = torch.empty((B, P, (2 * radius + 1) ** 2), dtype=f1.dtype, device=f1.device)
    if out.numel() == 0:
        return out
    with kernels.on_device_of(f1):
        kernels.launch(
            "corr_window", f1.data_ptr(), f2.data_ptr(), cen.data_ptr(),
            out.data_ptr(), B, P, Hp, Wp, C, radius, group, float(C) ** -0.5,
            int(f1.dtype == torch.bfloat16), kernels.stream_of(f1),
        )
    return out


def corr_window(f1, f2, cen, Hp: int, Wp: int, radius: int, group: int = 1) -> torch.Tensor:
    """One level's window: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if f1.device.type == "cpu":
        return corr_window_plain(f1, f2, cen, Hp, Wp, radius, group)
    return corr_window_cuda(f1, f2, cen, Hp, Wp, radius, group)


def corr_lookup(
    feat1: torch.Tensor, feat2: torch.Tensor, flow: torch.Tensor, radius: int,
    num_levels: int, group: int = 1,
) -> torch.Tensor:
    """Windowed correlation lookup over ``num_levels`` pyramid levels.

    feat1 (B, H, W, C) template side, feat2 (B/group, H, W, C) query side
    (each map shared by ``group`` consecutive streams, never repeated),
    flow (B, H, W, 2) in cells, channels (x, y).  Returns
    (B, H, W, L*(2r+1)^2): one launch per level, at centres
    (coords + flow) / 2^i in fp32 over feat2 avg-pooled i times.
    """
    if feat1.shape[0] % feat2.shape[0] != 0:
        raise ValueError(
            f"template batch {feat1.shape[0]} is not a multiple of query batch "
            f"{feat2.shape[0]}; the shared query maps need an integer group"
        )
    B, H, W, C = feat1.shape
    B2 = feat2.shape[0]
    n = 2 * radius + 1
    grid = pixel_coords_grid(H, W, device=flow.device) + flow.float()
    f1 = feat1.reshape(B, H * W, C)
    outs = []
    pooled = feat2
    for i in range(num_levels):
        if i > 0:
            pooled = avg_pool2d(pooled, 2)
        Hp, Wp = pooled.shape[1], pooled.shape[2]
        cen = (grid / (2.0**i)).reshape(B, H * W, 2)
        win = corr_window(f1, pooled.reshape(B2, Hp * Wp, C), cen, Hp, Wp, radius, group)
        outs.append(win.reshape(B, H, W, n * n))
    return torch.cat(outs, dim=-1)
