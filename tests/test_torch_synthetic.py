"""The port's synthetic sphere scenes (data/synthetic.py, numpy only)
against the JAX package's (which crops with cv2): the same views for the
same poses.

``warp_affine`` writes out cv2.warpAffine's float32 arithmetic, so the
views are held bitwise: rgb within 1e-5 and then equal, mask, crop affine
and the template points equal; the poses, built in closed form where the
JAX package goes through scipy's quaternions, within 1e-12.
"""

import cv2
import numpy as np
import pytest

from picopose_tpu.data import synthetic as J
from picopose_tpu_torch.data import synthetic as T

POSES = [(0.3, 0.4, 0.45), (0.45, 0.52, 0.6), (2.0, -0.3, 0.5), (-1.2, 1.1, 0.7)]


@pytest.mark.parametrize("az,el,z", POSES)
def test_make_pose_matches_jax(az, el, z):
    np.testing.assert_allclose(T.make_pose(az, el, z), J.make_pose(az, el, z), atol=1e-12, rtol=0)


@pytest.mark.parametrize("crop", [224, 112])
@pytest.mark.parametrize("az,el,z", POSES)
def test_make_view_matches_jax(az, el, z, crop):
    pose = J.make_pose(az, el, z)
    ref, got = J.make_view(pose, 0.05, crop=crop), T.make_view(pose, 0.05, crop=crop)
    np.testing.assert_allclose(got.rgb, ref.rgb, atol=1e-5, rtol=0)
    for name in ("rgb", "mask", "M", "K", "pose", "full_depth", "depth_crop_pts"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(T.query_pts2d(got.M, crop), J.query_pts2d(ref.M, crop))


@pytest.mark.parametrize("channels", [0, 3])
@pytest.mark.parametrize("nearest", [False, True])
def test_warp_affine_is_cv2s(rng, channels, nearest):
    """Random crop affines, some reaching past the image (the constant
    border), some with half-pixel sample points (nearest rounds to even)."""
    H, W = 96, 128
    img = rng.random((H, W) if channels == 0 else (H, W, channels)).astype(np.float32)
    flags = cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR
    mats = [np.array([[2, 0, -1], [0, 2, -3], [0, 0, 1]], np.float32)]
    for _ in range(6):
        s, cx, cy = 64 / rng.uniform(10, 200), rng.uniform(-20, W + 20), rng.uniform(-20, H + 20)
        mats.append(np.array([[s, 0, 32 - s * cx], [0, s, 32 - s * cy], [0, 0, 1]], np.float32))
    for M in mats:
        ref = cv2.warpAffine(img, M[:2], (64, 64), flags=flags)
        np.testing.assert_array_equal(T.warp_affine(img, M, 64, nearest=nearest), ref)
