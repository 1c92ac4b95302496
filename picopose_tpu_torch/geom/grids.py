"""Static coordinate grids for the flow decoder and the correspondences.

Counterpart of picopose_tpu/geom/grids.py: (H, W, 2) grids with channels
(x, y), channel-last.
"""

from __future__ import annotations

import torch


def patch_center_grid(
    size: int, patch: float, dtype=torch.float32, device=None
) -> torch.Tensor:
    """(n, n, 2) patch-centre pixel coordinates, n = round(size / patch):
    grid[r, c] = (patch*c + patch/2, patch*r + patch/2)."""
    n = int(round(size / patch))
    centers = torch.arange(n, dtype=dtype, device=device) * patch + patch / 2.0
    yy, xx = torch.meshgrid(centers, centers, indexing="ij")
    return torch.stack([xx, yy], dim=-1)


def pixel_coords_grid(H: int, W: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(H, W, 2) integer pixel coordinates, grid[y, x] = (x, y)."""
    yy, xx = torch.meshgrid(
        torch.arange(H, dtype=dtype, device=device),
        torch.arange(W, dtype=dtype, device=device),
        indexing="ij",
    )
    return torch.stack([xx, yy], dim=-1)
