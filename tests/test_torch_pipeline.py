"""The port's stages 1-2 end to end against the JAX package.

``build_bank`` -> ``select_templates`` -> ``stage2_poses`` of
picopose_tpu_torch/eval/pipeline.py must reproduce the JAX composition
of picopose_tpu/eval/pipeline.py:86-127 (``jax_stages_1_2`` below, the
same lines) at the same weights: 6 synthetic template views, B = 2
queries, hyp = 3.

fp32 (products summed in other orders on the two sides; measured max
errors in brackets): equal ids; scores within 1e-6 [6e-8 on ~0.7]; bank
taps and DPT pyramids within 5e-5 + 1e-5 relative [3e-5 on ~14];
pred_Ms and poses within 1e-4 + 1e-5 relative [6e-5 on ~120, 2e-5 on
~10].
bf16: the two sides round at different points (the LN square, the
attention scale and P, GELU; the port rounds the normalised matching
operands to bf16 as the TPU kernel path does, XLA on the CPU keeps them
fp32).  Each query is one of the template views, so the best match is a
clear winner and must agree; its score within 1e-3 [8e-5] and its
pred_M and stage-2 pose within 5e-2 + 5e-2 relative [7e-2 on ~110,
2.3e-2 on ~4].
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import SMALL, assert_close, random_flax_variables

from picopose_tpu.data.synthetic import make_pose, make_view
from picopose_tpu.eval import pipeline as jp
from picopose_tpu.geom.affine import affine_from_prediction
from picopose_tpu.geom.pose2d import pose_from_affine_2d
from picopose_tpu.models import PicoPose as JaxPicoPose
from picopose_tpu.ops.matching import match_templates
from picopose_tpu_torch.eval.pipeline import build_bank, select_templates, stage2_poses
from picopose_tpu_torch.models import PicoPose
from picopose_tpu_torch.utils.weights import load_flax_variables

HYP = 3
FP32_FEATS = dict(atol=5e-5, rtol=1e-5)
FP32_POSES = dict(atol=1e-4, rtol=1e-5)
VIEW_ANGLES = [(0.3, 0.4), (1.2, 0.3), (2.4, 0.9), (4.0, 1.2), (5.2, 0.7), (0.9, 1.4)]


def jax_stages_1_2(model, variables, batch, bank, hyp):
    """picopose_tpu/eval/pipeline.py:86-127, as run_batch runs them."""
    _take = jp._take
    B = batch["real_rgb"].shape[0]
    feats_real = model.apply(variables, batch["real_rgb"], method=model.features)
    scores, ids = match_templates(bank.feats[-1], feats_real[-1], batch["real_mask"], topk=hyp)
    BH = B * hyp
    tem_last = _take(bank.feats[-1], ids)
    tem_mask = _take(bank.mask, ids)
    tem_pose = _take(bank.pose, ids)
    tem_K = _take(bank.K, ids)
    tem_M = _take(bank.M, ids)

    def tile(x):
        reps = (1, hyp) + (1,) * (x.ndim - 1)
        return jnp.tile(x[:, None], reps).reshape(BH, *x.shape[1:])

    real_last = tile(feats_real[-1])
    real_M = tile(batch["real_M"])
    real_K = tile(batch["real_K"])
    translation, scale, inplane = model.apply(
        variables, tem_last, real_last, tem_mask, method=model.stage2
    )
    pred_Ms = affine_from_prediction(scale, inplane, translation, tem_pose, tem_K, tem_M)
    poses_2d = pose_from_affine_2d(real_M, real_K, pred_Ms, tem_K, tem_M, tem_pose)
    return scores, ids, pred_Ms, poses_2d


@pytest.fixture(scope="module")
def world():
    tviews = [make_view(make_pose(a, e, z=0.45)) for a, e in VIEW_ANGLES]
    bank_np = [np.stack([getattr(v, k) for v in tviews]) for k in
               ("rgb", "mask", "depth_crop_pts", "pose", "K", "M")]
    bank_np = [a.astype(np.float32) for a in bank_np]
    return tviews, bank_np


def _batch(views):
    return {
        "real_rgb": np.stack([v.rgb for v in views]).astype(np.float32),
        "real_mask": np.stack([v.mask for v in views]).astype(np.float32),
        "real_M": np.stack([v.M for v in views]).astype(np.float32),
        "real_K": np.stack([v.K for v in views]).astype(np.float32),
    }


def _run_both(jdtype, tdtype, bank_np, batch, cache_dpt):
    jmodel = JaxPicoPose(**SMALL, compute_dtype=jdtype)
    variables = random_flax_variables(jmodel, seed=0)
    tmodel = PicoPose(**SMALL, compute_dtype=tdtype, device="cpu")
    load_flax_variables(tmodel, variables)

    jbank = jp.build_bank(jmodel, variables, *(jnp.asarray(a) for a in bank_np),
                          chunk=4, cache_dpt=cache_dpt)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    stages = jax.jit(jax_stages_1_2, static_argnames=("model", "hyp"))
    ref = [np.asarray(x) for x in stages(jmodel, variables, jbatch, jbank, hyp=HYP)]

    tbank = build_bank(tmodel, *bank_np, chunk=4, cache_dpt=cache_dpt)
    feats_real, scores, ids = select_templates(tmodel, batch, tbank, hyp=HYP)
    pred_Ms, poses_2d = stage2_poses(tmodel, batch, tbank, feats_real, ids)
    got = [x.float().numpy() if x.is_floating_point() else x.numpy()
           for x in (scores, ids, pred_Ms, poses_2d)]
    return jbank, tbank, ref, got


@pytest.fixture(scope="module")
def fp32_run(world):
    _, bank_np = world
    queries = [make_view(make_pose(a, e, z=0.6)) for a, e in [(0.45, 0.52), (2.2, 1.0)]]
    return _run_both(jnp.float32, torch.float32, bank_np, _batch(queries), cache_dpt=True)


def test_fp32_bank_matches(fp32_run):
    jbank, tbank, _, _ = fp32_run
    for i in range(4):
        assert_close(tbank.feats[i].numpy(), jbank.feats[i], what=f"tap {i}", **FP32_FEATS)
    for i in range(3):
        assert_close(tbank.dpt[i].numpy(), jbank.dpt[i], what=f"dpt {i}", **FP32_FEATS)


def test_fp32_ids_and_scores_match(fp32_run):
    _, _, (r_scores, r_ids, _, _), (scores, ids, _, _) = fp32_run
    assert ids.shape == (2, HYP)
    np.testing.assert_array_equal(ids, r_ids)
    assert_close(scores, r_scores, atol=1e-6, what="scores")


def test_fp32_stage2_poses_match(fp32_run):
    _, _, (_, _, r_Ms, r_poses), (_, _, pred_Ms, poses) = fp32_run
    assert pred_Ms.shape == (2 * HYP, 3, 3) and poses.shape == (2 * HYP, 4, 4)
    assert_close(pred_Ms, r_Ms, what="pred_Ms", **FP32_POSES)
    assert_close(poses, r_poses, what="poses_2d", **FP32_POSES)
    R = poses[:, :3, :3]
    np.testing.assert_allclose(R.transpose(0, 2, 1) @ R, np.broadcast_to(np.eye(3), R.shape), atol=1e-5)


def test_bf16_best_match_and_pose(world):
    tviews, bank_np = world
    batch = _batch([tviews[1], tviews[4]])  # queries identical to views 1 and 4
    _, _, ref, got = _run_both(jnp.bfloat16, torch.bfloat16, bank_np, batch, cache_dpt=False)
    (r_scores, r_ids, r_Ms, r_poses), (scores, ids, pred_Ms, poses) = ref, got
    np.testing.assert_array_equal(ids[:, 0], [1, 4])
    np.testing.assert_array_equal(ids[:, 0], r_ids[:, 0])
    assert_close(scores[:, 0], r_scores[:, 0], atol=1e-3, what="best score")
    best = np.arange(2) * HYP  # hypothesis 0 of each query
    assert_close(pred_Ms[best], r_Ms[best], atol=5e-2, rtol=5e-2, what="best pred_Ms")
    assert_close(poses[best], r_poses[best], atol=5e-2, rtol=5e-2, what="best pose")
