"""The training step's geometry in the port against the JAX package: the
pinhole projections (geom/projection.py), the ground-truth stage-2 targets
(geom/affine.py's GT helpers) and the GT keypoint correspondences
(train/keypoints.py), on the same seeded inputs.

Tolerances: the projections and GT helpers are fp32 on both sides and
agree to 1e-5 (atol + rtol: values are O(1-500), rounding order only).
``sample_keypoints`` defines the supervision, so its ``valid`` grid and
its points (truncated integer pixels over the patch size) are held equal
on synthetic view pairs, with the tar-roundtrip distance filter on and
off.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_geom import _cams, _poses

from picopose_tpu.data.synthetic import make_pose, make_view
from picopose_tpu.geom import affine as ja
from picopose_tpu.geom import projection as jproj
from picopose_tpu.train import keypoints as jk
from picopose_tpu_torch.geom import affine as ta
from picopose_tpu_torch.geom import projection as tproj
from picopose_tpu_torch.train import keypoints as tk

TOL = dict(atol=1e-5, rtol=1e-5)
t = torch.from_numpy


def test_projection_matches_jax(rng):
    B, N = 3, 50
    K, _ = _cams(rng, B)
    T = _poses(rng, B)
    pts = np.stack([rng.uniform(-0.1, 0.1, (B, N)), rng.uniform(-0.1, 0.1, (B, N)),
                    rng.uniform(0.3, 0.9, (B, N))], -1).astype(np.float32)
    pix = rng.uniform(-20, 660, (B, N, 2)).astype(np.float32)  # some outside the depth map
    depth = rng.uniform(0.3, 0.9, (B, 48, 64)).astype(np.float32)
    depth[:, ::7] = 0.0
    pairs = [
        (tproj.project_points(t(pts), t(K)), jproj.project_points(pts, K)),
        (tproj.unproject_points(t(pix), t(K), t(depth)), jproj.unproject_points(pix, K, depth)),
        (tproj.transform_points(t(T), t(pts)), jproj.transform_points(T, pts)),
        (tproj.depth_to_points(t(depth), t(K)), jproj.depth_to_points(depth, K)),
    ]
    for i, (got, ref) in enumerate(pairs):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), err_msg=f"function {i}", **TOL)


def test_gt_helpers_match_jax(rng):
    B = 16
    args = []
    for _ in range(2):
        K, M = _cams(rng, B)
        args.append((K, M, _poses(rng, B)))
    (sK, sM, sP), (tK, tM, tP) = args
    order = (sK, tK, sP, tP, sM, tM)
    got = ta.relative_scale_inplane(*map(t, order)) + ta.gt_translation_scale_inplane(*map(t, order)) \
        + (ta.relative_affine(*map(t, order)),)
    ref = ja.relative_scale_inplane(*order) + ja.gt_translation_scale_inplane(*order) \
        + (ja.relative_affine(*order),)
    assert len(got) == len(ref) == 6
    for i, (a, b) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=f"output {i}", **TOL)


def _view_pairs(crop):
    """Template and query views of one sphere: overlapping viewpoints, a
    pair seen from far apart, and one nearly the same view."""
    poses = [((0.3, 0.4, 0.45), (0.45, 0.52, 0.6)), ((1.0, -0.2, 0.5), (2.4, 0.6, 0.55)),
             ((-0.5, 0.2, 0.6), (-0.48, 0.21, 0.6))]
    batch = {}
    for side, idx in (("tem", 0), ("real", 1)):
        views = [make_view(make_pose(*p[idx]), 0.05, crop=crop) for p in poses]
        for key in ("mask", "M", "K", "pose", "full_depth"):
            batch[f"{side}_{key}"] = np.stack([getattr(v, key) for v in views])
    return batch


@pytest.mark.parametrize("crop", [224, 112])
@pytest.mark.parametrize("tar_filter", [True, False])
def test_sample_keypoints_match_jax(crop, tar_filter):
    b = _view_pairs(crop)
    T = np.einsum("bij,bjk->bik", b["real_pose"], np.linalg.inv(b["tem_pose"])).astype(np.float32)
    args = (b["tem_mask"], b["tem_M"], b["tem_K"], b["tem_full_depth"],
            b["real_mask"], b["real_M"], b["real_K"], T)
    tar_depth = b["real_full_depth"] if tar_filter else None
    ref = jk.sample_keypoints(*map(jnp.asarray, args), tar_depth=tar_depth, crop=crop)
    got = tk.sample_keypoints(*map(t, args), tar_depth=None if tar_depth is None else t(tar_depth), crop=crop)
    valid = np.asarray(ref.valid)
    assert got.valid.shape == valid.shape == (3, 64, 64)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert 200 < valid[0].sum() < 4096 and valid[2].sum() > valid[1].sum()  # the pairs are not trivial
    np.testing.assert_array_equal(got.src_pts.numpy(), np.asarray(ref.src_pts))
    np.testing.assert_array_equal(got.tar_pts.numpy(), np.asarray(ref.tar_pts))


def test_keypoint_mask_lookup_truncates_toward_zero():
    """(-0.5, 0) truncates to column 0, as ``.long()`` does, not to -1."""
    mask = torch.ones(1, 4, 4)
    pts = torch.tensor([[[-0.5, 0.0], [3.9, 3.9], [4.0, 0.0], [-1.0, 0.0]]])
    assert tk._mask_lookup(pts, mask).tolist() == [[True, True, False, False]]
