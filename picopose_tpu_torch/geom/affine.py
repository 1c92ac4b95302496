"""Batched 2D affine math on (x, y) pixel points: the pieces stage 2 uses,
and the ground-truth targets training derives from two posed crops.

Counterpart of picopose_tpu/geom/affine.py:18-219.  Matrices are
(..., 3, 3) acting on homogeneous column vectors (x, y, 1).

Everything here is fp32 geometry.  ``torch.matmul`` on fp32 CUDA tensors
runs in full fp32 only while ``torch.backends.cuda.matmul.allow_tf32`` is
False; the pipeline's entry points (eval/pipeline.py) call these under
``device.full_fp32``, which pins it, because pose accuracy does not
survive TF32's 10-bit mantissa.
"""

from __future__ import annotations

import torch

from picopose_tpu_torch.geom.fma import apply_rows
from picopose_tpu_torch.geom.rotation import cos_sin, inplane_angle_zxy, rotation_2d

# 2D translations predicted by the stage-2 head are in units of TRANS_SCALE px
TRANS_SCALE = 14.0


def mmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full-precision batched matmul (fp32, no TF32)."""
    return torch.matmul(a, b)


def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., i, j) x (..., j) -> (..., i)."""
    return torch.matmul(M, v.unsqueeze(-1)).squeeze(-1)


def homogenize(points: torch.Tensor) -> torch.Tensor:
    """(..., N, 2) -> (..., N, 3) by appending ones."""
    ones = torch.ones(
        (*points.shape[:-1], 1), dtype=points.dtype, device=points.device
    )
    return torch.cat([points, ones], dim=-1)


def apply_affine(M: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply (..., 3, 3) affine(s) to (..., N, 2) points -> (..., N, 2),
    dividing by the homogeneous coordinate (``fma.apply_rows``)."""
    out = apply_rows(M, homogenize(points))
    return out[..., :2] / out[..., 2:3]


def make_affine(
    rotation: torch.Tensor,
    scale: torch.Tensor | float | None = None,
    translation: torch.Tensor | None = None,
) -> torch.Tensor:
    """Compose (..., 3, 3) affines: M[:2,:2] = scale * rotation,
    M[:2,2] = translation."""
    batch = rotation.shape[:-2]
    lin = rotation
    if scale is not None:
        s = torch.as_tensor(scale, dtype=rotation.dtype, device=rotation.device)
        lin = lin * s[..., None, None]
    t = (
        translation
        if translation is not None
        else rotation.new_zeros((*batch, 2))
    )
    top = torch.cat([lin, t[..., :, None]], dim=-1)  # (..., 2, 3)
    bottom = (torch.arange(3, device=rotation.device) == 2).to(rotation.dtype)  # (0, 0, 1), no host copy
    bottom = bottom.expand(*batch, 1, 3)
    return torch.cat([top, bottom], dim=-2)


def compose_affine(*Ms: torch.Tensor) -> torch.Tensor:
    """Left-to-right composition: compose_affine(A, B) == A @ B."""
    out = Ms[0]
    for M in Ms[1:]:
        out = mmul(out, M)
    return out


def inverse_crop_affine(M: torch.Tensor) -> torch.Tensor:
    """Invert an isotropic-scale, rotation-free crop affine:
    M_inv[:2,:2] = I/s, M_inv[:2,2] = -t/s."""
    scale = M[..., 0, 0]
    eye = torch.eye(2, dtype=M.dtype, device=M.device).expand(*M.shape[:-2], 2, 2)
    inv_t = -M[..., :2, 2] / scale[..., None]
    return make_affine(rotation=eye, scale=1.0 / scale, translation=inv_t)


def normalize_affine(M: torch.Tensor) -> torch.Tensor:
    """Strip the scale (norm of the first column) from the linear part,
    keeping a pure 2D rotation with zero translation and [2,2] = 1."""
    scale = torch.linalg.vector_norm(M[..., :2, 0], dim=-1)
    out = torch.zeros_like(M)
    out[..., :2, :2] = M[..., :2, :2] / scale[..., None, None]
    out[..., 2, 2] = 1.0
    return out


def _center2d_in_crop(
    pose: torch.Tensor, K: torch.Tensor, M: torch.Tensor
) -> torch.Tensor:
    """Object center (pose translation) in crop coordinates:
    M @ dehomog(K @ t).  Returns (..., 2)."""
    c = _matvec(K, pose[..., :3, 3])
    c = c / c[..., 2:3]
    return _matvec(M, c)[..., :2]


def affine_from_prediction(
    pred_scale: torch.Tensor,
    pred_cos_sin: torch.Tensor,
    pred_translation: torch.Tensor,
    tem_pose: torch.Tensor,
    tem_K: torch.Tensor,
    tem_M: torch.Tensor,
    trans_scale: float = TRANS_SCALE,
) -> torch.Tensor:
    """Compose the stage-2 prediction into a template-crop -> query-crop
    affine, anchored at the template's projected 2D center."""
    M = make_affine(rotation=rotation_2d(pred_cos_sin), scale=pred_scale)
    tem_c = _center2d_in_crop(tem_pose, tem_K, tem_M)
    moved = apply_affine(M, tem_c[..., None, :])[..., 0, :]
    target = tem_c + pred_translation * trans_scale
    out = M.clone()
    out[..., :2, 2] = target - moved
    return out


def relative_scale_inplane(
    src_K: torch.Tensor, tar_K: torch.Tensor, src_pose: torch.Tensor, tar_pose: torch.Tensor,
    src_M: torch.Tensor, tar_M: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Ground-truth relative 2D scale and in-plane angle, src crop -> tar
    crop: scale = (src_z / tar_z) * (|tar_M| / |src_M|) / (src_f / tar_f);
    inplane = the z angle (extrinsic 'zxy') of tar_R @ src_R^T, in
    [0, 2 pi)."""
    rel_z = src_pose[..., 2, 3] / tar_pose[..., 2, 3]
    rel_crop = torch.linalg.vector_norm(tar_M[..., :2, 0], dim=-1) / torch.linalg.vector_norm(
        src_M[..., :2, 0], dim=-1
    )
    rel_focal = src_K[..., 0, 0] / tar_K[..., 0, 0]
    rel_R = mmul(tar_pose[..., :3, :3], src_pose[..., :3, :3].transpose(-1, -2))
    inplane = inplane_angle_zxy(rel_R)
    return rel_z * rel_crop / rel_focal, torch.remainder(inplane + 2.0 * torch.pi, 2.0 * torch.pi)


def gt_translation_scale_inplane(src_K, tar_K, src_pose, tar_pose, src_M, tar_M):
    """Stage-2 targets (translation (..., 2) in crop pixels, scale,
    inplane): the translation moves the template's projected object
    centre onto the query's; the loss divides it by ``TRANS_SCALE``."""
    rel_scale, rel_inplane = relative_scale_inplane(src_K, tar_K, src_pose, tar_pose, src_M, tar_M)
    tar_c = _center2d_in_crop(tar_pose, tar_K, tar_M)
    src_c = _center2d_in_crop(src_pose, src_K, src_M)
    return tar_c - src_c, rel_scale, rel_inplane


def relative_affine(src_K, tar_K, src_pose, tar_pose, src_M, tar_M) -> torch.Tensor:
    """Ground-truth src-crop -> tar-crop affine: the relative in-plane
    rotation and scale, anchored so the template's projected centre lands
    on the query's."""
    rel_scale, rel_inplane = relative_scale_inplane(src_K, tar_K, src_pose, tar_pose, src_M, tar_M)
    M = make_affine(rotation=rotation_2d(cos_sin(rel_inplane)), scale=rel_scale)
    src_c = _center2d_in_crop(src_pose, src_K, src_M)
    tar_c = _center2d_in_crop(tar_pose, tar_K, tar_M)
    moved = apply_affine(M, src_c[..., None, :])[..., 0, :]
    out = M.clone()
    out[..., :2, 2] = tar_c - moved
    return out
