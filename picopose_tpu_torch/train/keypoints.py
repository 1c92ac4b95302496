"""Ground-truth keypoint correspondences between two posed RGB-D crops.

Counterpart of picopose_tpu/train/keypoints.py:32-127: the 64 x 64 patch
centre grid of one crop is lifted to 3D through its full-resolution depth,
moved by the relative pose, reprojected into the other crop and masked at
every step.  Validity is a boolean grid, not -1 sentinels.

The reference's quirks are kept, because this defines the supervision:
  * coordinates are truncated toward zero (the reference writes back
    ``.long()`` coordinates), so the lift runs on integer crop pixels;
  * its final "mutual distance" filter compares reprojected points in
    *crop* coordinates with the other side's grid in *original-image*
    coordinates (a frame mismatch that makes the < 1000 px test mostly an
    in-range check), and counts only grid points whose own roundtrip is
    valid.

The filter's squared-distance matrix is (B, 4096, 4096) fp32 (537 MB at
batch 8) and cancellation-prone: it runs in full fp32 (``full_fp32``), as
the JAX package's ``precision="highest"`` einsum does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from picopose_tpu_torch.device import full_fp32
from picopose_tpu_torch.geom.affine import apply_affine, inverse_crop_affine
from picopose_tpu_torch.geom.grids import patch_center_grid
from picopose_tpu_torch.geom.projection import project_points, transform_points, unproject_points


class KeypointData(NamedTuple):
    src_pts: torch.Tensor  # (B, 64, 64, 2) src grid in patch units
    tar_pts: torch.Tensor  # (B, 64, 64, 2) reprojection in the tar crop, patch units
    valid: torch.Tensor    # (B, 64, 64) bool


def _mask_lookup(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Valid where the truncated (x, y) is inside ``mask`` and mask >= 0.5."""
    H, W = mask.shape[-2:]
    xi = points[..., 0].to(torch.int64)
    yi = points[..., 1].to(torch.int64)
    inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    idx = torch.clamp(yi, 0, H - 1) * W + torch.clamp(xi, 0, W - 1)
    m = torch.gather(mask.reshape(*mask.shape[:-2], H * W), -1, idx)
    return inb & (m >= 0.5)


def _roundtrip(pts_crop, pts_trunc, mask_a, M_a, K_a, depth_a, mask_b, M_b, K_b, T_a2b):
    """Truncated crop grid on side a -> 3D -> side b's crop.  Returns
    (valid, the reprojection truncated, side a's points in original-image
    coordinates clamped to its depth map)."""
    v = _mask_lookup(pts_crop, mask_a)
    pts_img = apply_affine(inverse_crop_affine(M_a), pts_trunc)
    # the reference clamps the coordinates in place to the depth bounds and
    # the clamped values flow onward
    H0, W0 = depth_a.shape[-2], depth_a.shape[-1]
    pts_img = torch.stack(
        [torch.clamp(pts_img[..., 0], 0, W0 - 1), torch.clamp(pts_img[..., 1], 0, H0 - 1)], dim=-1
    )
    pts3d = unproject_points(pts_img, K_a, depth_a)
    v = v & (pts3d[..., 2] > 1e-6)
    reproj_crop = apply_affine(M_b, project_points(transform_points(T_a2b, pts3d), K_b))
    v = v & _mask_lookup(reproj_crop, mask_b)
    return v, torch.trunc(reproj_crop), pts_img


@torch.no_grad()
@full_fp32()
def sample_keypoints(
    src_mask: torch.Tensor,   # (B, S, S) crop masks
    src_M: torch.Tensor,      # (B, 3, 3) crop affines
    src_K: torch.Tensor,
    src_depth: torch.Tensor,  # (B, H0, W0) full-image depth
    tar_mask: torch.Tensor,
    tar_M: torch.Tensor,
    tar_K: torch.Tensor,
    T_src2tar: torch.Tensor,  # (B, 4, 4)
    tar_depth: torch.Tensor | None = None,
    crop: int = 224,
    grid: int = 64,
) -> KeypointData:
    """GT correspondences from the src crop's grid into the tar crop.
    ``tar_depth=None`` leaves out the reference's tar-roundtrip distance
    filter."""
    B = src_mask.shape[0]
    N = grid * grid
    dev = src_mask.device
    pts_crop = patch_center_grid(crop, crop / grid, device=dev).reshape(1, N, 2).expand(B, N, 2)
    pts_trunc = torch.trunc(pts_crop)
    valid, reproj_crop, _ = _roundtrip(
        pts_crop, pts_trunc, src_mask, src_M, src_K, src_depth, tar_mask, tar_M, tar_K, T_src2tar
    )
    if tar_depth is not None:
        tar_valid, _, tar_img = _roundtrip(
            pts_crop, pts_trunc, tar_mask, tar_M, tar_K, tar_depth, src_mask, src_M, src_K,
            torch.linalg.inv_ex(T_src2tar).inverse,  # inv checks its result on the host
        )
        # min over the valid tar points of |reprojected src (crop) - tar (original image)|^2
        d2 = (
            (reproj_crop**2).sum(-1)[:, :, None]
            + (tar_img**2).sum(-1)[:, None, :]
            - 2.0 * torch.bmm(reproj_crop, tar_img.transpose(1, 2))
        )
        d2 = torch.where(tar_valid[:, None, :], d2, torch.inf)
        valid = valid & (d2.amin(dim=-1) < 1000.0**2)
    patch = crop / grid
    return KeypointData(
        (pts_trunc / patch).reshape(B, grid, grid, 2),
        (reproj_crop / patch).reshape(B, grid, grid, 2),
        valid.reshape(B, grid, grid),
    )
