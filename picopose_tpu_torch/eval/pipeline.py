"""The first half of the inference pipeline: template bank, template
selection and the stage-2 pose.

Counterpart of picopose_tpu/eval/pipeline.py: ``build_bank`` (:246-279)
and ``select_templates`` followed by ``stage2_poses``, whose composition
is exactly run_batch's stages 1-2 (:86-127).  The stage-2 pose is what
run_batch returns wherever PnP fails.

Shapes: B = instance batch, N = template views, HYP = hypotheses; the
hypothesis axis is folded into the batch axis for stage 2.  Inputs may be
numpy arrays or tensors; they are moved to the model's device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from picopose_tpu_torch.geom.affine import affine_from_prediction
from picopose_tpu_torch.geom.pose2d import pose_from_affine_2d
from picopose_tpu_torch.ops.matching import match_templates


class TemplateBank(NamedTuple):
    """One object's templates on the device: all four backbone taps and
    (``cache_dpt``) the template-side DPT pyramids, so no query re-runs
    template work."""

    feats: tuple[torch.Tensor, ...]  # 4 x (N, 16, 16, C)
    mask: torch.Tensor               # (N, Hc, Wc) crop masks
    pts3d: torch.Tensor              # (N, 64, 64, 3) camera-frame points
    pose: torch.Tensor               # (N, 4, 4)
    K: torch.Tensor                  # (N, 3, 3)
    M: torch.Tensor                  # (N, 3, 3) crop affines
    dpt: tuple[torch.Tensor, ...] | None = None  # 3 x (N, g_l, g_l, 256)


def _to(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, device=device)


def _take(bank_arr: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Gather (N, ...) bank entries with (B, HYP) ids -> (B*HYP, ...)."""
    return bank_arr[ids.reshape(-1)]


def _tile(x: torch.Tensor, hyp: int) -> torch.Tensor:
    """(B, ...) -> (B*HYP, ...), each item repeated HYP times in a row."""
    return x[:, None].expand(x.shape[0], hyp, *x.shape[1:]).reshape(-1, *x.shape[1:])


@torch.inference_mode()
def build_bank(
    model, tem_rgb, tem_mask, tem_pts3d, tem_pose, tem_K, tem_M,
    chunk: int = 32, cache_dpt: bool = True,
) -> TemplateBank:
    """Backbone taps (and DPT pyramids) of all N views, ``chunk`` views at a
    time to bound peak memory."""
    dev = model.device
    rgb = _to(tem_rgb, dev)
    feats_chunks, dpt_chunks = [], []
    for s in range(0, rgb.shape[0], chunk):
        f = model.features(rgb[s : s + chunk])
        feats_chunks.append(f)
        if cache_dpt:
            dpt_chunks.append(model.dpt(f))
    feats = tuple(torch.cat([c[i] for c in feats_chunks]) for i in range(4))
    dpt = (
        tuple(torch.cat([c[i] for c in dpt_chunks]) for i in range(3))
        if cache_dpt else None
    )
    return TemplateBank(
        feats=feats, mask=_to(tem_mask, dev), pts3d=_to(tem_pts3d, dev),
        pose=_to(tem_pose, dev), K=_to(tem_K, dev), M=_to(tem_M, dev), dpt=dpt,
    )


@torch.inference_mode()
def select_templates(model, batch: dict, bank: TemplateBank, hyp: int = 5):
    """Stage 1: query features once, matched against the bank.

    batch: real_rgb (B, 224, 224, 3) CLIP-normalised, real_mask
    (B, 224, 224).  Returns (feats_real: 4 x (B, 16, 16, C), scores
    (B, HYP), ids (B, HYP)), best match first.
    """
    dev = model.device
    feats_real = model.features(_to(batch["real_rgb"], dev))
    scores, ids = match_templates(
        bank.feats[-1], feats_real[-1], _to(batch["real_mask"], dev), topk=hyp
    )
    return feats_real, scores, ids


@torch.inference_mode()
def stage2_poses(model, batch: dict, bank: TemplateBank, feats_real, ids: torch.Tensor):
    """Stage 2 for every (query, hypothesis): the affine head on the
    selected templates, the template->query affine and the recovered pose.

    batch: real_M (B, 3, 3), real_K (B, 3, 3).  Returns (pred_Ms
    (B*HYP, 3, 3), poses_2d (B*HYP, 4, 4)), hypotheses folded into the
    batch axis in ``ids`` order.
    """
    dev = model.device
    hyp = ids.shape[1]
    tem_last = _take(bank.feats[-1], ids)
    tem_mask = _take(bank.mask, ids)
    tem_pose = _take(bank.pose, ids)
    tem_K = _take(bank.K, ids)
    tem_M = _take(bank.M, ids)
    real_last = _tile(feats_real[-1], hyp)
    real_M = _tile(_to(batch["real_M"], dev), hyp)
    real_K = _tile(_to(batch["real_K"], dev), hyp)

    translation, scale, inplane = model.stage2(tem_last, real_last, tem_mask)
    pred_Ms = affine_from_prediction(scale, inplane, translation, tem_pose, tem_K, tem_M)
    poses_2d = pose_from_affine_2d(real_M, real_K, pred_Ms, tem_K, tem_M, tem_pose)
    return pred_Ms, poses_2d
