"""6D pose recovery from a predicted 2D crop-to-crop affine (the stage-2
pose, also the fallback where PnP fails).

Counterpart of picopose_tpu/geom/pose2d.py:15-55.
"""

from __future__ import annotations

import torch

from picopose_tpu_torch.geom.affine import (
    _matvec,
    inverse_crop_affine,
    mmul,
    normalize_affine,
)


def pose_from_affine_2d(
    query_M: torch.Tensor,
    query_K: torch.Tensor,
    pred_Ms: torch.Tensor,
    template_K: torch.Tensor,
    template_M: torch.Tensor,
    template_pose: torch.Tensor,
) -> torch.Tensor:
    """Recover (..., 4, 4) query poses from predicted template->query affines.

    1. rotation: the scale-stripped in-plane rotation left-composed onto the
       template rotation;
    2. 2D center: inv(query_M) @ pred_Ms @ tem_M applied to the template's
       projected center;
    3. depth: z_query = (z_template / scale2d) * (f_query / f_template);
    4. translation: the ray through the recovered center, scaled to z_query.
    """
    R_inplane = normalize_affine(pred_Ms)
    pred_pose = template_pose.clone()
    pred_pose[..., :3, :3] = mmul(R_inplane, template_pose[..., :3, :3])

    tem_z = pred_pose[..., 2, 3]
    tem_c = _matvec(template_K, pred_pose[..., :3, 3])
    tem_c = tem_c / tem_c[..., 2:3]

    affine2d = mmul(mmul(inverse_crop_affine(query_M), pred_Ms), template_M)
    query_c = _matvec(affine2d, tem_c)

    scale2d = torch.linalg.vector_norm(affine2d[..., :2, 0], dim=-1)
    focal_ratio = query_K[..., 0, 0] / template_K[..., 0, 0]
    query_z = (tem_z / scale2d) * focal_ratio

    ray = _matvec(torch.linalg.inv(query_K), query_c)
    ray = ray / ray[..., 2:3]
    pred_pose[..., :3, 3] = ray * query_z[..., None]
    return pred_pose
