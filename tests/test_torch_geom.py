"""The port's fp32 geometry (picopose_tpu_torch/geom) against the JAX
package on the same seeded inputs.  Both sides compute in fp32 with full
precision matrix products; values are O(1-100) and agree to 1e-5
relative (rounding order only)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picopose_tpu.geom import affine as ja
from picopose_tpu.geom import pose2d as jp
from picopose_tpu.geom import rotation as jr
from picopose_tpu_torch.geom import affine as ta
from picopose_tpu_torch.geom import pose2d as tp
from picopose_tpu_torch.geom import rotation as tr

TOL = dict(atol=1e-5, rtol=1e-5)


def _poses(rng, n):
    out = np.zeros((n, 4, 4), np.float32)
    for i in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        out[i, :3, :3] = q * np.sign(np.linalg.det(q))
        out[i, :3, 3] = [rng.normal() * 0.05, rng.normal() * 0.05, rng.uniform(0.4, 0.8)]
        out[i, 3, 3] = 1.0
    return out


def _cams(rng, n):
    K = np.zeros((n, 3, 3), np.float32)
    K[:, 0, 0] = K[:, 1, 1] = rng.uniform(500, 600, n)
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = 320, 240, 1
    M = np.zeros((n, 3, 3), np.float32)
    s = rng.uniform(0.8, 1.6, n)
    M[:, 0, 0] = M[:, 1, 1] = s
    M[:, :2, 2] = rng.uniform(-300, -100, (n, 2))
    M[:, 2, 2] = 1
    return K, M


@pytest.fixture
def inputs():
    rng = np.random.default_rng(11)
    n = 8
    K, M = _cams(rng, n)
    qK, qM = _cams(rng, n)
    cs = rng.normal(size=(n, 2)).astype(np.float32)
    cs /= np.linalg.norm(cs, axis=-1, keepdims=True)
    return dict(
        scale=rng.uniform(0.5, 2.0, n).astype(np.float32), cos_sin=cs,
        trans=rng.normal(size=(n, 2)).astype(np.float32), pose=_poses(rng, n),
        K=K, M=M, qK=qK, qM=qM,
    )


def test_rotation_helpers_match(inputs):
    rng = np.random.default_rng(3)
    ang = rng.uniform(-np.pi, np.pi, 16).astype(np.float32)
    np.testing.assert_allclose(tr.cos_sin(torch.from_numpy(ang)).numpy(), np.asarray(jr.cos_sin(jnp.asarray(ang))), **TOL)
    cs = inputs["cos_sin"]
    np.testing.assert_allclose(tr.rotation_2d(torch.from_numpy(cs)).numpy(), np.asarray(jr.rotation_2d(jnp.asarray(cs))), **TOL)
    R = inputs["pose"][:, :3, :3]
    np.testing.assert_allclose(
        tr.inplane_angle_zxy(torch.from_numpy(R)).numpy(), np.asarray(jr.inplane_angle_zxy(jnp.asarray(R))), **TOL
    )


def test_affine_helpers_match(inputs):
    M = inputs["M"]
    pts = np.random.default_rng(4).uniform(0, 224, (8, 5, 2)).astype(np.float32)
    np.testing.assert_allclose(
        ta.apply_affine(torch.from_numpy(M), torch.from_numpy(pts)).numpy(),
        np.asarray(ja.apply_affine(jnp.asarray(M), jnp.asarray(pts))), **TOL,
    )
    np.testing.assert_allclose(
        ta.inverse_crop_affine(torch.from_numpy(M)).numpy(), np.asarray(ja.inverse_crop_affine(jnp.asarray(M))), **TOL
    )
    R = ta.make_affine(tr.rotation_2d(torch.from_numpy(inputs["cos_sin"])), torch.from_numpy(inputs["scale"]))
    np.testing.assert_allclose(ta.normalize_affine(R).numpy(), np.asarray(ja.normalize_affine(jnp.asarray(R.numpy()))), **TOL)
    np.testing.assert_allclose(
        ta.compose_affine(R, torch.from_numpy(M)).numpy(),
        np.asarray(ja.compose_affine(jnp.asarray(R.numpy()), jnp.asarray(M))), **TOL,
    )


def test_stage2_affine_and_pose_match(inputs):
    i = inputs
    args = (i["scale"], i["cos_sin"], i["trans"], i["pose"], i["K"], i["M"])
    ref_M = ja.affine_from_prediction(*(jnp.asarray(a) for a in args))
    got_M = ta.affine_from_prediction(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got_M.numpy(), np.asarray(ref_M), **TOL)

    pargs = (i["qM"], i["qK"], np.asarray(ref_M), i["K"], i["M"], i["pose"])
    ref_pose = np.asarray(jp.pose_from_affine_2d(*(jnp.asarray(a) for a in pargs)))
    got_pose = tp.pose_from_affine_2d(*(torch.from_numpy(np.array(a)) for a in pargs)).numpy()
    np.testing.assert_allclose(got_pose, ref_pose, **TOL)
    R = got_pose[:, :3, :3]
    np.testing.assert_allclose(R.transpose(0, 2, 1) @ R, np.broadcast_to(np.eye(3), R.shape), atol=1e-5)


# ---- public helpers and the package's re-exports -----------------------------


@pytest.mark.parametrize("eps", [0.0, 1e-6])
def test_geodesic_distance_matches(inputs, eps):
    """Pairs at dot +-1 exactly (where eps keeps arccos finite in the
    gradient) among random ones; the mean within 1e-5."""
    rng = np.random.default_rng(8)
    pred = inputs["cos_sin"]
    gt = rng.normal(size=pred.shape).astype(np.float32)
    gt /= np.linalg.norm(gt, axis=-1, keepdims=True)
    gt[0], gt[1] = pred[0], -pred[1]
    got = tr.geodesic_distance(torch.from_numpy(pred), torch.from_numpy(gt), eps)
    ref = jr.geodesic_distance(jnp.asarray(pred), jnp.asarray(gt), eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("level", [0, 1])
def test_template_helpers_are_the_jax_ones(level):
    """opencv_from_opengl and upper_hemisphere_index: the same numpy
    arithmetic, equal bit for bit."""
    from picopose_tpu.geom import templates as jt
    from picopose_tpu_torch.geom import templates as tt

    cams = tt.template_camera_poses(level)
    np.testing.assert_array_equal(tt.opencv_from_opengl(cams), jt.opencv_from_opengl(cams))
    np.testing.assert_array_equal(tt.opencv_from_opengl(tt.opencv_from_opengl(cams)), cams)
    up = tt.upper_hemisphere_index(level)
    np.testing.assert_array_equal(up, jt.upper_hemisphere_index(level))
    assert 0 < len(up) < len(cams)


def _exported(package) -> set:
    import types

    return {n for n, v in vars(package).items() if not n.startswith("_") and not isinstance(v, types.ModuleType)}


@pytest.mark.parametrize("name", ["geom", "ops"])
def test_packages_reexport_the_jax_packages_names(name):
    """picopose_tpu_torch.geom and .ops export what picopose_tpu.geom and
    .ops do, each name the port module's function of that name."""
    import importlib

    jpkg = importlib.import_module(f"picopose_tpu.{name}")
    tpkg = importlib.import_module(f"picopose_tpu_torch.{name}")
    assert set(tpkg.__all__) == _exported(jpkg)
    for n in tpkg.__all__:
        fn = getattr(tpkg, n)
        assert callable(fn) and fn.__name__ == n
        assert fn.__module__.replace("picopose_tpu_torch", "picopose_tpu") == getattr(jpkg, n).__module__
