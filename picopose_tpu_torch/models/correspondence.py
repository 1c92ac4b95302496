"""Dense correspondences between the template and query patch grids.

Counterpart of picopose_tpu/models/correspondence.py: the stage-2 affine
seeds the flow, and the finest flow plus its certainty give dense
correspondences with a validity mask (fixed shapes, no compaction).
"""

from __future__ import annotations

import torch

from picopose_tpu_torch.geom.affine import apply_affine
from picopose_tpu_torch.geom.grids import patch_center_grid, pixel_coords_grid
from picopose_tpu_torch.ops.resize import resize_nearest


def init_correspondences(pred_Ms: torch.Tensor, tem_mask: torch.Tensor, grid: int = 16):
    """pred_Ms (B, 3, 3) template-crop -> query-crop affines, tem_mask
    (B, Hc, Wc).  Returns (flow (B, g, g, 2), certainty (B, g, g, 1)):
    flow = M @ patch_centre / patch - (c, r) where the nearest-downsampled
    mask is set, -(c, r) where it is not; certainty is that mask."""
    B, Hc = pred_Ms.shape[0], tem_mask.shape[1]
    patch = Hc / grid
    dev = pred_Ms.device
    mask = resize_nearest(tem_mask, (grid, grid)).to(pred_Ms.dtype)
    centers = patch_center_grid(Hc, patch, device=dev).reshape(1, grid * grid, 2)
    pred = apply_affine(pred_Ms, centers.expand(B, grid * grid, 2))
    pred = (pred / patch).reshape(B, grid, grid, 2)
    flow = pred * mask[..., None] - pixel_coords_grid(grid, grid, device=dev)
    return flow, mask[..., None]


def final_correspondences(flow: torch.Tensor, certainty: torch.Tensor, threshold: float = 0.5):
    """flow (B, H, W, 2), certainty logits (B, H, W, 1) -> (tar_pts
    (B, H*W, 2) query-grid coordinates, valid (B, H*W)): sigmoid > threshold
    and the target strictly inside, tested as the reference writes it
    (x against H - 1, y against W - 1)."""
    B, H, W, _ = flow.shape
    tar = flow + pixel_coords_grid(H, W, dtype=flow.dtype, device=flow.device)
    inside = (
        (tar[..., 0] > 0) & (tar[..., 1] > 0)
        & (tar[..., 0] < H - 1) & (tar[..., 1] < W - 1)
    )
    valid = inside & (torch.sigmoid(certainty[..., 0]) > threshold)
    return tar.reshape(B, H * W, 2), valid.reshape(B, H * W)
