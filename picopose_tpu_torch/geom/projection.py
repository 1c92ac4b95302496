"""Pinhole projection and unprojection over batched points and depth maps.

Counterpart of picopose_tpu/geom/projection.py:13-72.  Points are
(..., N, 2) pixels or (..., N, 3) camera-frame coordinates; intrinsics
(..., 3, 3), rigid transforms (..., 4, 4).  fp32 geometry: on the card
the callers run these under ``device.full_fp32`` (no TF32 products); on
the CPU the products are XLA's fused multiply-add chains (``fma.apply_rows``).
"""

from __future__ import annotations

import torch

from picopose_tpu_torch.geom.fma import apply_rows


def project_points(points3d: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) camera-frame points -> (..., N, 2) pixels."""
    p = apply_rows(K, points3d)
    return p[..., :2] / p[..., 2:3]


def unproject_points(points2d: torch.Tensor, K: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Lift (..., N, 2) pixels to camera-frame 3D with a (..., H, W) depth
    map read at the clamped pixel, truncated toward zero (nearest lookup):
    p3d = depth * K^-1 @ (x, y, 1)."""
    H, W = depth.shape[-2], depth.shape[-1]
    xi = torch.clamp(points2d[..., 0], 0, W - 1).to(torch.int64)
    yi = torch.clamp(points2d[..., 1], 0, H - 1).to(torch.int64)
    d = torch.gather(depth.reshape(*depth.shape[:-2], H * W), -1, yi * W + xi)
    ph = torch.cat([points2d, torch.ones_like(points2d[..., :1])], dim=-1)
    rays = apply_rows(torch.linalg.inv_ex(K).inverse, ph)  # inv checks on the host
    return rays * d[..., None]


def depth_to_points(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Dense unprojection: (..., H, W) depth -> (..., H, W, 3) camera points,
    X = (x - cx) * z / fx, Y = (y - cy) * z / fy, Z = z."""
    H, W = depth.shape[-2], depth.shape[-1]
    ex = lambda v: v[..., None, None]
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=depth.dtype, device=depth.device),
        torch.arange(W, dtype=depth.dtype, device=depth.device),
        indexing="ij",
    )
    X = (xs - ex(K[..., 0, 2])) * depth / ex(K[..., 0, 0])
    Y = (ys - ex(K[..., 1, 2])) * depth / ex(K[..., 1, 1])
    return torch.stack([X, Y, depth], dim=-1)


def transform_points(T: torch.Tensor, points3d: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) rigid transform(s) to (..., N, 3) points."""
    return apply_rows(T[..., :3, :3], points3d) + T[..., None, :3, 3]
