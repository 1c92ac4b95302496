"""The inference pipeline: template bank, crops -> ranked poses.

Counterpart of picopose_tpu/eval/pipeline.py: ``build_bank`` (:246-279)
and ``run_batch`` (:61-232), which composes ``select_templates`` and
``stage2_poses`` (stages 1-2, :86-127) with stage 3 (DPT pyramids, the
flow decoder, dense correspondences), batched RANSAC-PnP, the stage-2
fallback where PnP fails and the ranking by inlier ratio.

``run_batch_graphed`` and ``build_bank_graphed`` are the compiled
programs (utils/graphs.py): CUDA graphs captured at fixed shapes and
replayed, as the JAX package jit-compiles ``run_batch_jit`` (:235-243)
and the bank build's ``feat_fn`` / ``dpt_fn`` (:262-263).  ``replica_on``
gives the model, its programs and its PnP generator on another device,
for the entry points that run over several (serve.py, eval/runner.py).

Shapes: B = instance batch, N = template views, HYP = hypotheses; the
hypothesis axis is folded into the batch axis for stage 2.  Inputs may be
numpy arrays or tensors; they are moved to the model's device.  Every
entry point runs under ``device.full_fp32``: its fp32 products (stage 2,
the geometry, PnP) take no TF32, whatever the process flags.  The DPT
head and the flow decoder run only on a model in ``.eval()`` (running
BatchNorm statistics); a model left in ``.train()`` is refused.
"""

from __future__ import annotations

import copy
from typing import NamedTuple

import torch

from picopose_tpu_torch.device import full_fp32, indexed
from picopose_tpu_torch.geom.affine import affine_from_prediction
from picopose_tpu_torch.geom.pose2d import pose_from_affine_2d
from picopose_tpu_torch.models.correspondence import final_correspondences, init_correspondences
from picopose_tpu_torch.ops.matching import match_mode_from_env, match_templates
from picopose_tpu_torch.ops.pnp import _inv3, ransac_pnp
from picopose_tpu_torch.utils.graphs import GraphCache


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

    def to(self, device: torch.device) -> "TemplateBank":
        """The bank's arrays or tensors as tensors on ``device``."""
        move = lambda x: None if x is None else torch.as_tensor(x, device=device)
        return TemplateBank(
            feats=tuple(move(f) for f in self.feats), mask=move(self.mask), pts3d=move(self.pts3d),
            pose=move(self.pose), K=move(self.K), M=move(self.M),
            dpt=None if self.dpt is None else tuple(move(d) for d in self.dpt),
        )


class Replica(NamedTuple):
    """The model, its compiled programs and its PnP generator on one device."""

    model: object
    graphs: GraphCache
    generator: torch.Generator


def replica_on(home: Replica, device: torch.device, seed: int) -> Replica:
    """``home`` on its model's own device (a card compares equal however it
    is named); on another device a copy of its (precast) model, a
    ``GraphCache`` of its own (a CUDA graph belongs to one device) that
    shares ``home``'s capture lock, and a generator seeded with ``seed``."""
    device = indexed(torch.device(device))
    if device == indexed(home.model.device):
        return home
    model = copy.deepcopy(home.model).to(device)
    model.device = device
    graphs = GraphCache(device)
    graphs.lock = home.graphs.lock
    return Replica(model, graphs, torch.Generator(device=device).manual_seed(seed))


class EvalOutput(NamedTuple):
    R: torch.Tensor               # (B, HYP, 3, 3) ranked best-first
    t: torch.Tensor               # (B, HYP, 3)
    inlier_ratio: torch.Tensor    # (B, HYP); -1 where stage 3 was skipped
    pnp_success: torch.Tensor     # (B, HYP) bool
    template_score: torch.Tensor  # (B, HYP) matching scores (pre-ranking order)


def _to(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, device=device)


def _eval_mode(model) -> None:
    if model.training:
        raise ValueError(
            "the inference pipeline takes a model in eval mode (running BatchNorm statistics); "
            "call model.eval() after training"
        )


def _take(bank_arr: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Gather (N, ...) bank entries with (B, HYP) ids -> (B*HYP, ...)."""
    return bank_arr[ids.reshape(-1)]


def _tile(x: torch.Tensor, hyp: int) -> torch.Tensor:
    """(B, ...) -> (B*HYP, ...), each item repeated HYP times in a row."""
    return x[:, None].expand(x.shape[0], hyp, *x.shape[1:]).reshape(-1, *x.shape[1:])


def _chunk_program(model, cache_dpt: bool):
    """One chunk of views -> (4 backbone taps, 3 DPT pyramids or None)."""

    def program(rgb: torch.Tensor):
        f = model.features(rgb)
        return tuple(f), (tuple(model.dpt(f)) if cache_dpt else None)

    return program


def _assemble_bank(model, chunk_fn, tem_rgb, tem_mask, tem_pts3d, tem_pose, tem_K, tem_M,
                   chunk: int, cache_dpt: bool) -> TemplateBank:
    if cache_dpt:
        _eval_mode(model)
    dev = model.device
    rgb = _to(tem_rgb, dev)
    parts = [chunk_fn(rgb[s : s + chunk]) for s in range(0, rgb.shape[0], chunk)]
    feats = tuple(torch.cat([p[0][i] for p in parts]) for i in range(4))
    dpt = tuple(torch.cat([p[1][i] for p in parts]) for i in range(3)) if cache_dpt else None
    return TemplateBank(
        feats=feats, mask=_to(tem_mask, dev), pts3d=_to(tem_pts3d, dev),
        pose=_to(tem_pose, dev), K=_to(tem_K, dev), M=_to(tem_M, dev), dpt=dpt,
    )


@torch.inference_mode()
@full_fp32()
def build_bank(
    model, tem_rgb, tem_mask, tem_pts3d, tem_pose, tem_K, tem_M,
    chunk: int = 32, cache_dpt: bool = True,
) -> TemplateBank:
    """Backbone taps (and DPT pyramids) of all N views, ``chunk`` views at a
    time to bound peak memory."""
    return _assemble_bank(model, _chunk_program(model, cache_dpt), tem_rgb, tem_mask, tem_pts3d,
                          tem_pose, tem_K, tem_M, chunk, cache_dpt)


@torch.inference_mode()
@full_fp32()
def build_bank_graphed(
    graphs: GraphCache, model, tem_rgb, tem_mask, tem_pts3d, tem_pose, tem_K, tem_M,
    chunk: int = 32, cache_dpt: bool = True,
) -> TemplateBank:
    """``build_bank`` with each chunk's features and DPT pyramids as one
    program of ``graphs`` (counterpart of the JAX ``build_bank``'s jitted
    ``feat_fn`` / ``dpt_fn``, picopose_tpu/eval/pipeline.py:262-263): a
    162-view bank in chunks of 32 is two programs, 32 views and the last
    2.  The same banks as ``build_bank``, bitwise."""
    program = _chunk_program(model, cache_dpt)
    chunk_fn = lambda rgb: graphs.run("bank_chunk", program, (rgb,), static=(cache_dpt,), module=model)
    return _assemble_bank(model, chunk_fn, tem_rgb, tem_mask, tem_pts3d, tem_pose, tem_K, tem_M,
                          chunk, cache_dpt)


@torch.inference_mode()
@full_fp32()
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
@full_fp32()
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


class Correspondences(NamedTuple):
    """Stage-3 output for the B*k3 refined hypotheses."""

    flows: list         # 3 x (B*k3, g, g, 2) fp32, coarse to fine
    certs: list         # 3 x (B*k3, g, g, 1) fp32 logits
    tar_pts: torch.Tensor    # (B*k3, G*G, 2) query-grid targets
    valid: torch.Tensor      # (B*k3, G*G) bool, template depth included
    model_pts: torch.Tensor  # (B*k3, G*G, 3) template points, model frame
    pts2d: torch.Tensor      # (B*k3, G*G, 2) query pixels at the target cells


@torch.inference_mode()
@full_fp32()
def stage3_correspondences(
    model, batch: dict, bank: TemplateBank, feats_real, ids: torch.Tensor, pred_Ms: torch.Tensor,
) -> Correspondences:
    """Stage 3 for the hypotheses ``ids`` (B, k3): template pyramids from
    the bank (or the DPT on its taps), the query pyramid once at B, the
    flow decoder seeded by the stage-2 affines ``pred_Ms`` (B*k3, 3, 3),
    and dense 2D-3D correspondences."""
    _eval_mode(model)
    dev = model.device
    B, k3 = ids.shape
    init_flow, init_cert = init_correspondences(pred_Ms, _take(bank.mask, ids), grid=bank.feats[-1].shape[1])
    if bank.dpt is not None:
        tem_pyr = [_take(p, ids) for p in bank.dpt]
    else:
        tem_pyr = model.dpt([_take(f, ids) for f in bank.feats])
    flows, certs = model.flow(tem_pyr, model.dpt(feats_real), init_flow, init_cert)
    G = bank.pts3d.shape[1]
    if flows[-1].shape[1:3] != bank.pts3d.shape[1:3]:
        # the JAX package fails here too (picopose_tpu/eval/pipeline.py:161-197)
        raise ValueError(
            f"the flow decoder's finest level has {tuple(flows[-1].shape[1:3])} cells and the bank's points "
            f"{tuple(bank.pts3d.shape[1:3])}: dense correspondences need num_levels 3, the model has "
            f"{model.flow_decoder.num_levels}"
        )
    tar_pts, valid = final_correspondences(flows[-1], certs[-1])

    # query pixels at the integer target cells, in closed form through
    # the crop affine's inverse (the patch-centre grid mapped by M^-1)
    patch = batch["real_rgb"].shape[1] / G
    cell = lambda v: v.clamp(-1.0, float(G)).to(torch.int32).clamp(0, G - 1).float()
    cx = (cell(tar_pts[..., 0]) + 0.5) * patch
    cy = (cell(tar_pts[..., 1]) + 0.5) * patch
    Minv = _inv3(_tile(_to(batch["real_M"], dev), k3))
    px, py, pw = (Minv[:, None, i, 0] * cx + Minv[:, None, i, 1] * cy + Minv[:, None, i, 2] for i in range(3))
    pts2d = torch.stack([px / pw, py / pw], dim=-1)

    # template camera points -> model frame, as multiply-adds
    tem_pose = _take(bank.pose, ids)
    cam_pts = _take(bank.pts3d, ids).reshape(B * k3, G * G, 3)
    Rt, tt = tem_pose[:, :3, :3], tem_pose[:, :3, 3]
    centered = cam_pts - tt[:, None]
    model_pts = (
        centered[..., 0:1] * Rt[:, None, 0, :]
        + centered[..., 1:2] * Rt[:, None, 1, :]
        + centered[..., 2:3] * Rt[:, None, 2, :]
    )
    valid = valid & (cam_pts[..., 2] > 1e-6)  # no template depth -> invalid
    return Correspondences(flows, certs, tar_pts, valid, model_pts, pts2d)


def run_batch(
    model, batch: dict, bank: TemplateBank, hyp: int = 5, pnp_iters: int = 150,
    stage3_topk: int | None = None, generator: torch.Generator | None = None,
    pnp_draws=None,
) -> EvalOutput:
    """Crops of one object's bank -> HYP ranked poses per crop.

    batch: real_rgb (B, 224, 224, 3) CLIP-normalised, real_mask
    (B, 224, 224), real_M (B, 3, 3), real_K (B, 3, 3).  stage3_topk: run
    stage 3 and PnP only for that many best-matching hypotheses; the rest
    keep their stage-2 poses with inlier ratio -1 (None = all, the
    reference's behaviour).  PnP draws come from ``generator``, or from
    ``pnp_draws(valid) -> (sample_idx, subset_idx)`` where given.
    """
    return _ranked(model, batch, bank, hyp, pnp_iters, stage3_topk, generator, pnp_draws)[0]


@torch.inference_mode()
@full_fp32()
def _ranked(model, batch, bank, hyp, pnp_iters, stage3_topk, generator, pnp_draws):
    """``run_batch``'s (EvalOutput, ids, order): ids (B, HYP) the matched
    template views, best match first; order (B, HYP) the ranking (output
    slot j holds hypothesis order[:, j])."""
    dev = model.device
    feats_real, scores, ids = select_templates(model, batch, bank, hyp=hyp)
    pred_Ms, poses_2d = stage2_poses(model, batch, bank, feats_real, ids)
    B = ids.shape[0]
    k3 = hyp if stage3_topk is None else min(stage3_topk, hyp)

    def head(x):  # (B*HYP, ...) -> (B*k3, ...), the first k3 hypotheses
        return x.reshape(B, hyp, *x.shape[1:])[:, :k3].reshape(B * k3, *x.shape[1:])

    corr = stage3_correspondences(model, batch, bank, feats_real, ids[:, :k3], head(pred_Ms))
    draws = pnp_draws(corr.valid) if pnp_draws is not None else (None, None)
    pnp = ransac_pnp(
        corr.model_pts, corr.pts2d, _tile(_to(batch["real_K"], dev), k3), corr.valid,
        iters=pnp_iters, generator=generator, sample_idx=draws[0], subset_idx=draws[1],
    )

    # stage-2 fallback where PnP failed; hypotheses outside stage 3 keep
    # their stage-2 poses with ratio -1
    p2 = poses_2d.reshape(B, hyp, 4, 4)
    p3 = head(poses_2d)
    ok = pnp.success
    R, t = p2[..., :3, :3].clone(), p2[..., :3, 3].clone()
    R[:, :k3] = torch.where(ok[:, None, None], pnp.R, p3[:, :3, :3]).reshape(B, k3, 3, 3)
    t[:, :k3] = torch.where(ok[:, None], pnp.t, p3[:, :3, 3]).reshape(B, k3, 3)
    ratio = torch.full((B, hyp), -1.0, device=dev)
    ratio[:, :k3] = pnp.inlier_ratio.reshape(B, k3)
    success = torch.zeros((B, hyp), dtype=torch.bool, device=dev)
    success[:, :k3] = ok.reshape(B, k3)

    # rank by inlier ratio, best first; ties keep the matching order
    order = torch.argsort(-ratio, dim=1, stable=True)
    out = EvalOutput(
        R=torch.take_along_dim(R, order[..., None, None], dim=1),
        t=torch.take_along_dim(t, order[..., None], dim=1),
        inlier_ratio=torch.take_along_dim(ratio, order, dim=1),
        pnp_success=torch.take_along_dim(success, order, dim=1),
        template_score=scores,
    )
    return out, ids, order


BATCH_KEYS = ("real_rgb", "real_mask", "real_M", "real_K")


def run_batch_graphed(
    graphs: GraphCache, model, batch: dict, bank: TemplateBank, hyp: int = 5, pnp_iters: int = 150,
    stage3_topk: int | None = None, generator: torch.Generator | None = None,
) -> EvalOutput:
    """``run_batch`` as one program of ``graphs``: the counterpart of the
    JAX package's ``run_batch_jit`` (picopose_tpu/eval/pipeline.py:235-243).

    Static: ``hyp``, ``pnp_iters``, ``stage3_topk`` and what Python reads
    at capture (the matching mode from the environment, the flow decoder's
    ``quantize`` and ``fuse_xheads``, and its ``num_levels`` and ``radius``,
    which the parameters' addresses alone would not tell apart).  Inputs: the batch's four arrays,
    copied in per call, and the bank, by value into one static slot per
    bank shape (copied in when another bank comes in: ~0.83 GB for a
    162-view ViT-L bank).  PnP draws come from ``generator`` (the
    device's default when None) as in ``run_batch``, replay by replay.
    A ``pnp_draws`` callback runs on the host, which no graph can hold:
    only the eager ``run_batch`` takes it.  Returns what ``run_batch``
    returns, as fresh tensors."""
    return _ranked_graphed(graphs, model, batch, bank, hyp, pnp_iters, stage3_topk, generator)[0]


@torch.inference_mode()
def _ranked_graphed(graphs, model, batch, bank, hyp, pnp_iters, stage3_topk, generator):
    """``_ranked`` as the program of ``run_batch_graphed``."""
    fd = model.flow_decoder
    static = (hyp, pnp_iters, stage3_topk, match_mode_from_env(), fd.quantize, fd.fuse_xheads,
              fd.num_levels, fd.radius)
    program = lambda b, bk: _ranked(model, b, bk, hyp, pnp_iters, stage3_topk, generator, None)
    args = ({k: torch.as_tensor(batch[k]) for k in BATCH_KEYS},)
    return graphs.run("run_batch", program, args, static=static, slot=bank, generator=generator, module=model)
