"""The port's ``run_batch`` against the JAX package's, end to end.

Both run the small model (vit_tiny_test, fp32) at the same weights on the
synthetic world of test_torch_pipeline.py: 6 template views, B = 2
queries, hyp = 3, 32 PnP iterations, with every hypothesis refined and
with ``stage3_topk=1``.  The PnP draws are the JAX package's, recovered
from its key (``torch_parity.jax_pnp_draws``) and injected into the port.

The flow and mask heads' predict convs are scaled (kernels x0.01, mask
bias 4), so stage 3 refines the stage-2 seed instead of scrambling it and
PnP sees ~3200 valid correspondences per hypothesis.  With unscaled
random heads only 8-81 cells stay valid, and RANSAC on so few noisy
points is chaotic: the JAX package's own ``ransac_pnp`` gives other
inlier ratios inside ``run_batch``'s jit than on its own.

Compared (measured max errors in brackets): template ids, equal; flows
and certainties of all three levels within 1e-3 + 1e-4 relative [1.3e-5
on ~60, 6.3e-5]; the share of equal valid masks, at least 0.999 [1.0];
then, for the queries whose hypotheses all have equal valid masks and
equal integer target cells (6 of 6 hypotheses, and 2 of 2 with
stage3_topk=1), the ranked outputs: success equal, inlier ratios within
1e-3 [0, equal] and the same ranking; R within 5e-3 [1.5e-3] and t
within 1e-3 [2.1e-4 on ~3], the pose being only weakly determined by a
small crop at ~3 m; the stage-2 poses kept with ratio -1 within 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pipeline import VIEW_ANGLES, _batch
from torch_parity import SMALL, assert_close, jax_pnp_draws, random_flax_variables

from picopose_tpu.data.synthetic import make_pose, make_view
from picopose_tpu.eval import pipeline as jp
from picopose_tpu.models import PicoPose as JaxPicoPose
from picopose_tpu.models.correspondence import final_correspondences, init_correspondences
from picopose_tpu_torch.eval import pipeline as tp
from picopose_tpu_torch.models import PicoPose
from picopose_tpu_torch.utils.weights import load_flax_variables

HYP, ITERS, B = 3, 32, 2
FLOW_TOL = dict(atol=1e-3, rtol=1e-4)


@functools.partial(jax.jit, static_argnames=("model", "hyp", "k3"))
def jax_stage3(model, variables, batch, bank, hyp, k3):
    """picopose_tpu/eval/pipeline.py:89-198 up to the PnP inputs: ids,
    flows, certainties, targets and the valid mask (depth included)."""
    feats_real = model.apply(variables, batch["real_rgb"], method=model.features)
    _, ids = jp.match_templates(bank.feats[-1], feats_real[-1], batch["real_mask"], topk=hyp)
    ids3 = ids[:, :k3]
    take = lambda a: jp._take(a, ids3)
    tem_last, tem_mask = take(bank.feats[-1]), take(bank.mask)
    translation, scale, inplane = model.apply(
        variables, tem_last, jnp.repeat(feats_real[-1], k3, axis=0), tem_mask, method=model.stage2
    )
    pred_Ms = jp.affine_from_prediction(
        scale, inplane, translation, take(bank.pose), take(bank.K), take(bank.M)
    )
    init_flow, init_cert = init_correspondences(pred_Ms, tem_mask, grid=tem_last.shape[1])
    real_pyr = model.apply(variables, feats_real, method=model.dpt)
    flows, certs = model.apply(
        variables, [take(p) for p in bank.dpt], real_pyr, init_flow, init_cert, method=model.flow
    )
    tar_pts, valid = final_correspondences(flows[-1], certs[-1])
    G = bank.pts3d.shape[1]
    valid &= take(bank.pts3d).reshape(-1, G * G, 3)[..., 2] > 1e-6
    return ids, flows, certs, tar_pts, valid


@pytest.fixture(scope="module")
def models():
    jmodel = JaxPicoPose(**SMALL, compute_dtype=jnp.float32)
    variables = random_flax_variables(jmodel, seed=0)
    fd = variables["params"]["flow_decoder"]
    for l in range(3):
        fd[f"flow_pred_{l}"]["predict"]["kernel"] *= 0.01
        fd[f"mask_pred_{l}"]["predict"]["bias"][:] = 4.0
    tmodel = PicoPose(**SMALL, compute_dtype=torch.float32, device="cpu")
    load_flax_variables(tmodel, variables)
    tviews = [make_view(make_pose(a, e, z=0.45)) for a, e in VIEW_ANGLES]
    bank_np = [np.stack([getattr(v, k) for v in tviews]).astype(np.float32)
               for k in ("rgb", "mask", "depth_crop_pts", "pose", "K", "M")]
    batch = _batch([make_view(make_pose(a, e, z=0.6)) for a, e in [(0.45, 0.52), (2.2, 1.0)]])
    jbank = jp.build_bank(jmodel, variables, *(jnp.asarray(a) for a in bank_np), chunk=4)
    tbank = tp.build_bank(tmodel, *bank_np, chunk=4)
    return jmodel, variables, tmodel, jbank, tbank, batch, bank_np


def _cells(tar):
    return np.clip(np.asarray(tar).astype(np.int32), 0, 63)


@pytest.fixture(scope="module", params=[None, 1], ids=["all", "topk1"])
def pair(request, models):
    jmodel, variables, tmodel, jbank, tbank, batch, _ = models
    k3 = HYP if request.param is None else request.param
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(0)
    ref_s3 = jax.tree_util.tree_map(np.asarray, jax_stage3(jmodel, variables, jbatch, jbank, HYP, k3))
    ref = jp.run_batch_jit(jmodel, variables, jbatch, jbank, key, hyp=HYP, pnp_iters=ITERS,
                           stage3_topk=request.param)

    feats_real, _, ids = tp.select_templates(tmodel, batch, tbank, hyp=HYP)
    pred_Ms, _ = tp.stage2_poses(tmodel, batch, tbank, feats_real, ids)
    head = pred_Ms.reshape(B, HYP, 3, 3)[:, :k3].reshape(B * k3, 3, 3)
    got_s3 = tp.stage3_correspondences(tmodel, batch, tbank, feats_real, ids[:, :k3], head)
    draws = lambda valid: tuple(torch.from_numpy(a).long() for a in jax_pnp_draws(key, valid.numpy(), ITERS))
    got = tp.run_batch(tmodel, batch, tbank, hyp=HYP, pnp_iters=ITERS, stage3_topk=request.param,
                       pnp_draws=draws)
    return k3, ref_s3, [np.asarray(x) for x in ref], ids.numpy(), got_s3, [x.numpy() for x in got]


def test_ids_match(pair):
    _, (r_ids, *_), _, ids, _, _ = pair
    assert ids.shape == (B, HYP)
    np.testing.assert_array_equal(ids, r_ids)


@pytest.mark.parametrize("level", range(3))
def test_flows_and_certainties_match(pair, level):
    k3, (_, r_flows, r_certs, _, _), _, _, s3, _ = pair
    g = 16 * 2**level
    assert s3.flows[level].shape == (B * k3, g, g, 2)
    assert_close(s3.flows[level].numpy(), r_flows[level], what=f"flow {level}", **FLOW_TOL)
    assert_close(s3.certs[level].numpy(), r_certs[level], what=f"cert {level}", **FLOW_TOL)


def test_ranked_poses_match_where_correspondences_agree(pair):
    k3, (_, _, _, r_tar, r_valid), ref, _, s3, got = pair
    valid, tar = s3.valid.numpy(), s3.tar_pts.numpy()
    assert (valid == r_valid).mean() >= 0.999
    agree = (valid == r_valid).all(1) & np.array(
        [(_cells(tar[h]) == _cells(r_tar[h]))[r_valid[h]].all() for h in range(B * k3)]
    )
    queries = agree.reshape(B, k3).all(1)
    assert queries.sum() * k3 == B * k3  # every hypothesis covered here
    (R, t, ratio, ok, score), (r_R, r_t, r_ratio, r_ok, r_score) = got, ref
    assert R.shape == (B, HYP, 3, 3) and t.shape == (B, HYP, 3)
    q = queries
    np.testing.assert_array_equal(ok[q], r_ok[q])
    assert_close(ratio[q], r_ratio[q], atol=1e-3, what="inlier ratio")
    assert np.all(np.diff(ratio, axis=1) <= 0)  # ranked best first
    assert_close(score, r_score, atol=1e-6, what="template scores")
    refined = ratio[q] >= 0
    assert_close(R[q][refined], r_R[q][refined], atol=5e-3, what="R")
    assert_close(t[q][refined], r_t[q][refined], atol=1e-3, what="t")
    assert_close(R[q][~refined], r_R[q][~refined], atol=1e-4, what="stage-2 R")
    assert_close(t[q][~refined], r_t[q][~refined], atol=1e-4, rtol=1e-5, what="stage-2 t")
    if k3 < HYP:
        assert np.all(ratio[:, k3:] == -1.0) and not ok[:, k3:].any()


def test_bank_without_pyramids_runs_the_dpt_on_its_taps(models):
    """bank.dpt is None: stage 3 runs the DPT on the selected views' taps
    and gives the cached pyramids' flows (same convs on the same inputs)."""
    _, _, tmodel, _, tbank, batch, bank_np = models
    bare = tp.build_bank(tmodel, *bank_np, chunk=4, cache_dpt=False)
    assert bare.dpt is None
    feats_real, _, ids = tp.select_templates(tmodel, batch, tbank, hyp=HYP)
    pred_Ms, _ = tp.stage2_poses(tmodel, batch, tbank, feats_real, ids)
    cached = tp.stage3_correspondences(tmodel, batch, tbank, feats_real, ids, pred_Ms)
    uncached = tp.stage3_correspondences(tmodel, batch, bare, feats_real, ids, pred_Ms)
    for a, b in zip(uncached.flows + uncached.certs, cached.flows + cached.certs):
        assert_close(a.numpy(), b.numpy(), atol=1e-5, what="flows from an uncached bank")
    assert torch.equal(uncached.valid, cached.valid)
