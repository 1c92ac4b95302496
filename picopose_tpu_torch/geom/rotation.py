"""Rotation helpers: 2D rotations from cos/sin, in-plane angle extraction.

Counterpart of picopose_tpu/geom/rotation.py.
"""

from __future__ import annotations

import torch


def cos_sin(angle: torch.Tensor) -> torch.Tensor:
    """(...,) angle -> (..., 2) stacked (cos, sin)."""
    return torch.stack([torch.cos(angle), torch.sin(angle)], dim=-1)


def rotation_2d(cs: torch.Tensor) -> torch.Tensor:
    """(..., 2) (cos, sin) -> (..., 2, 2) rotation [[c, -s], [s, c]]."""
    c, s = cs[..., 0], cs[..., 1]
    row0 = torch.stack([c, -s], dim=-1)
    row1 = torch.stack([s, c], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def inplane_angle_zxy(R: torch.Tensor) -> torch.Tensor:
    """First (z) angle of the extrinsic 'zxy' Euler decomposition of R.

    R = Ry(c) @ Rx(b) @ Rz(a) has middle row [cb*sa, cb*ca, -sb], so
    a = atan2(R[1,0], R[1,1]).
    """
    return torch.atan2(R[..., 1, 0], R[..., 1, 1])


def geodesic_distance(pred_cos_sin: torch.Tensor, gt_cos_sin: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Mean angle between (..., 2) cos/sin pairs, their dot clamped to
    [-1 + eps, 1 - eps] (eps 1e-6 gives arccos a finite gradient at +-1,
    as the in-plane loss uses it)."""
    dot = torch.clamp((pred_cos_sin * gt_cos_sin).sum(-1), -1.0 + eps, 1.0 - eps)
    return torch.arccos(dot).mean()
