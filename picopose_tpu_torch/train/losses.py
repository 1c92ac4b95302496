"""Training losses of the three stages.

Counterpart of picopose_tpu/train/losses.py:27-123.  Validity rides along
as masks (-inf logits, weighted means) instead of compacting the valid
correspondences, so every shape is static:
  * stage 1: infoNCE over matched patch features, tau 0.1;
  * stage 2: L1 translation (GT / 14 px), L2 log-scale (prediction clamped
    at 5e-3), geodesic in-plane angle (cosine clamped 1e-6 inside +-1);
  * stage 3, per level: BCE-with-logits certainty (weight 1) and masked L1
    flow (weight 0.1, flows of 400 cells and more left out);
  * total: the sum of every term, clamped at 100.

Inside ``parallel.collectives.data_parallel`` over more than one data rank
each rank holds its rows of the global batch, and every term is the
global batch's, as the JAX package's sharded step computes it: infoNCE
takes the rank's rows of the global logit matrix against every rank's
targets, the means and the flow L1's weighted sum reduce their sums and
counts over the data group, and every rank holds the same loss values.
On one rank the terms are computed as they always were.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from picopose_tpu_torch.geom.grids import pixel_coords_grid
from picopose_tpu_torch.geom.rotation import cos_sin
from picopose_tpu_torch.ops.matching import l2_normalize
from picopose_tpu_torch.ops.vjp import index_select
from picopose_tpu_torch.parallel.collectives import all_gather0, all_gather_rows, all_reduce_replicated, data_mesh


def _global_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The data group's sum of a loss's partial sum (every rank then holds
    the same value, read only by the replicated loss)."""
    return all_reduce_replicated(x, mesh.data_group)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the global batch (x.mean() on one rank)."""
    mesh = data_mesh()
    if mesh is None:
        return x.mean()
    return _global_sum(x.sum(), mesh) / float(x.numel() * mesh.n_data)


def info_nce_loss(
    src_feat: torch.Tensor,  # (B, h, w, C) template stage-1 features
    tar_feat: torch.Tensor,  # (B, h, w, C) query features
    src_pts: torch.Tensor,   # (B, G, G, 2) src grid, patch units of the G-grid
    tar_pts: torch.Tensor,   # (B, G, G, 2) reprojected, patch units
    valid: torch.Tensor,     # (B, G, G) bool
    tau: float = 0.1,
) -> torch.Tensor:
    """Symmetric-label infoNCE over the matched patch pairs: the G-grid
    correspondences nearest-downsampled (stride G / h) to the feature grid,
    features gathered at the truncated patch coordinates, one (B h w)^2
    logit matrix with invalid columns at -inf and invalid rows out of the
    mean."""
    B, h, w, C = src_feat.shape
    G = src_pts.shape[1]
    stride = G // h
    sp = src_pts[:, ::stride, ::stride] * (h / G)
    tp = tar_pts[:, ::stride, ::stride] * (h / G)
    m = valid[:, ::stride, ::stride].reshape(-1)

    def gather(feat, pts):  # rows whose backward sums in a fixed order (ops/vjp.py)
        xi = torch.clamp(pts[..., 0].to(torch.int64), 0, w - 1)
        yi = torch.clamp(pts[..., 1].to(torch.int64), 0, h - 1)
        idx = (yi * w + xi).reshape(B, h * w) + h * w * torch.arange(B, device=feat.device)[:, None]
        return index_select(feat.reshape(B * h * w, C), 0, idx.reshape(-1)).reshape(B, h * w, C)

    q = l2_normalize(gather(src_feat, sp).float()).reshape(-1, C)
    r = l2_normalize(gather(tar_feat, tp).float()).reshape(-1, C)
    mesh = data_mesh()
    if mesh is not None:  # this rank's rows of the global matrix
        return _info_nce_rows(q, r, m, tau, mesh)
    logits = torch.matmul(q, r.T) / tau
    logits = torch.where(m[None, :], logits, -torch.inf)
    diag = torch.diagonal(F.log_softmax(logits, dim=1))
    n = torch.clamp(m.sum(), min=1)
    return -torch.where(m, diag, 0.0).sum() / n


def _info_nce_rows(q, r, m, tau, mesh) -> torch.Tensor:
    """infoNCE over the global batch from this rank's rows: its queries
    against every rank's targets and validity (gathered in data order),
    its diagonal at its offset, the masked sum and the count over the
    data group."""
    rows = q.shape[0]
    r_all = all_gather_rows(r, mesh.data_group)
    m_all = all_gather0(m.to(torch.int32), mesh.data_group).bool()
    logits = torch.matmul(q, r_all.T) / tau
    logits = torch.where(m_all[None, :], logits, -torch.inf)
    i = torch.arange(rows, device=q.device)
    diag = F.log_softmax(logits, dim=1)[i, mesh.data_index * rows + i]
    n = torch.clamp(_global_sum(m.sum(), mesh), min=1)
    return -_global_sum(torch.where(m, diag, 0.0).sum(), mesh) / n


def stage2_loss(
    pred_translation, pred_scale, pred_inplane, gt_translation, gt_scale, gt_inplane_angle,
    trans_scale: float = 14.0,
):
    """(loss_2d_trans, loss_scale, loss_inplane)."""
    l_trans = batch_mean(torch.abs(pred_translation - gt_translation / trans_scale))
    l_scale = batch_mean((torch.log(torch.clamp(pred_scale, min=5e-3)) - torch.log(gt_scale)) ** 2)
    dot = torch.clamp((pred_inplane * cos_sin(gt_inplane_angle)).sum(-1), -1 + 1e-6, 1 - 1e-6)
    return l_trans, l_scale, batch_mean(torch.arccos(dot))


def flow_level_loss(
    pred_flow: torch.Tensor,       # (B, H, W, 2)
    pred_certainty: torch.Tensor,  # (B, H, W, 1) logits
    tar_pts: torch.Tensor,         # (B, G, G, 2) patch units of the G-grid
    valid: torch.Tensor,           # (B, G, G)
    flow_weight: float = 0.1,
    cert_weight: float = 1.0,
    max_flow: float = 400.0,
):
    """One level of the stage-3 loss: (flow L1, certainty BCE).  The GT flow
    is the nearest-downsampled tar grid at the level's resolution, zeroed
    outside validity, minus the identity grid."""
    B, H, W, _ = pred_flow.shape
    G = tar_pts.shape[1]
    stride = G // H
    gt_cert = valid[:, ::stride, ::stride]
    gt_tar = tar_pts[:, ::stride, ::stride] * (H / G)
    gt_flow = gt_tar * gt_cert[..., None] - pixel_coords_grid(H, W, device=pred_flow.device)

    z = pred_certainty[..., 0]
    y = gt_cert.to(torch.float32)
    # maximum, not clamp: at z == 0 it splits the gradient as jnp.maximum does
    bce = torch.maximum(z, torch.zeros_like(z)) - z * y + torch.log1p(torch.exp(-torch.abs(z)))
    l_cert = cert_weight * batch_mean(bce)

    mag = torch.sqrt((gt_flow**2).sum(-1))
    wt = ((y >= 0.5) & (mag < max_flow)).to(torch.float32)
    l1 = torch.abs(pred_flow - gt_flow).sum(-1)
    num, den = (wt * l1).sum(), wt.sum()
    mesh = data_mesh()
    if mesh is not None:
        num, den = _global_sum(num, mesh), _global_sum(den, mesh)
    return flow_weight * num / (den + 1e-10), l_cert


def total_loss(loss_dict: dict[str, torch.Tensor]) -> torch.Tensor:
    """Sum of every term, clamped at 100."""
    return torch.clamp(sum(loss_dict.values()), max=100.0)
