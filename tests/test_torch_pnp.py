"""The port's RANSAC-PnP against the JAX package's, with the JAX draws.

Both solvers get the same synthetic correspondences (a pose, 1500 model
points, 0.3 px noise, clear outliers) and the same random draws: the
JAX package's, recovered from its key as its ransac_pnp makes them
(``torch_parity.jax_pnp_draws``) and injected into the port's.  With
equal draws the two pick the same hypotheses, so what differs is fp32
arithmetic in another order (measured max errors in brackets): R within
1e-4 [6.0e-8], t within 1e-4 [7.5e-9], equal success and inlier ratios
within 1e-3 [0, equal].  Instances with fewer than 6 valid points, or
none, fail on both sides with the identity pose and ratio 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_close, jax_pnp_draws

from picopose_tpu.ops.pnp import ransac_pnp as jax_ransac_pnp
from picopose_tpu_torch.ops.pnp import draw_samples, ransac_pnp

K = np.array([[572.4114, 0, 320.0], [0, 573.57043, 240.0], [0, 0, 1.0]], np.float32)
ITERS = 150


def _scene(rng, n=1500, noise_px=0.3, outlier_frac=0.0, n_valid=None):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    R = q * np.sign(np.linalg.det(q))
    t = np.array([rng.uniform(-0.1, 0.1), rng.uniform(-0.1, 0.1), rng.uniform(0.6, 1.5)])
    X = rng.uniform(-0.08, 0.08, size=(n, 3))
    p = X @ R.T + t
    px = p[:, :2] / p[:, 2:] * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
    px += rng.normal(0, noise_px, px.shape)
    n_out = int(outlier_frac * n)
    if n_out:
        px[rng.choice(n, n_out, replace=False)] = rng.uniform([0, 0], [640, 480], size=(n_out, 2))
    valid = rng.random(n) > 0.1
    if n_valid is not None:
        valid[:] = False
        valid[:n_valid] = True
    return X.astype(np.float32), px.astype(np.float32), valid


@pytest.fixture(scope="module")
def solved():
    rng = np.random.default_rng(0)
    scenes = [_scene(rng), _scene(rng, outlier_frac=0.4), _scene(rng, outlier_frac=0.7),
              _scene(rng, n_valid=4), _scene(rng, n_valid=0)]
    X, px, valid = (np.stack([s[i] for s in scenes]) for i in range(3))
    Kb = np.stack([K] * len(scenes))
    key = jax.random.PRNGKey(3)
    ref = jax_ransac_pnp(*(jnp.asarray(a) for a in (X, px, Kb, valid)), key, iters=ITERS)
    sample_idx, subset_idx = jax_pnp_draws(key, valid, ITERS)
    got = ransac_pnp(
        *(torch.from_numpy(a) for a in (X, px, Kb, valid)), iters=ITERS,
        sample_idx=torch.from_numpy(sample_idx).long(), subset_idx=torch.from_numpy(subset_idx).long(),
    )
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


def test_success_and_inlier_ratios_match(solved):
    (_, _, r_ratio, r_ok), (_, _, ratio, ok) = solved
    np.testing.assert_array_equal(ok, r_ok)
    np.testing.assert_array_equal(ok, [True, True, True, False, False])
    assert_close(ratio, r_ratio, atol=1e-3, what="inlier ratio")
    assert ratio[0] > 0.9 and ratio[1] > 0.5


def test_poses_match(solved):
    (r_R, r_t, _, _), (R, t, _, _) = solved
    assert_close(R, r_R, atol=1e-4, what="R")
    assert_close(t, r_t, atol=1e-4, what="t")
    np.testing.assert_allclose(R.transpose(0, 2, 1) @ R, np.broadcast_to(np.eye(3), R.shape), atol=1e-5)


@pytest.mark.parametrize("b", [3, 4])
def test_too_few_valid_points_fail_with_the_identity(solved, b):
    _, (R, t, ratio, ok) = solved
    assert not ok[b] and ratio[b] == 0.0
    np.testing.assert_array_equal(R[b], np.eye(3))
    np.testing.assert_array_equal(t[b], [0.0, 0.0, 1.0])


def test_own_draws_sample_the_valid_points():
    valid = torch.from_numpy(np.random.default_rng(1).random((3, 300)) > 0.6)
    valid[2] = False
    g = torch.Generator().manual_seed(0)
    sample_idx, subset_idx = draw_samples(valid, 40, 6, 128, g)
    assert sample_idx.shape == (3, 40, 6) and subset_idx.shape == (3, 128)
    for b in range(2):
        assert valid[b, sample_idx[b]].all()
        n = int(valid[b].sum())
        assert valid[b, subset_idx[b, : min(n, 128)]].all()
        assert len(set(subset_idx[b].tolist())) == 128  # without replacement
    assert (sample_idx[2] == 0).all()  # no valid point: the table's first entry
