"""The port's CPU arithmetic that makes its parity tests independent of the
host's vector width (AVX2 or AVX-512):

* ``geom/fma.py``: ``fma32`` rounds ``a * b + c`` once, as a fused
  multiply-add does (checked against exact rational arithmetic, on inputs
  drawn to land on fp32 rounding ties and near them); ``apply_rows`` is
  bitwise the JAX package's ``precision="highest"`` einsums on the CPU
  (XLA's multiply-add chain) for the geometry's affines, intrinsics and
  rotations, and ``torch.matmul`` under autograd.
* ``device.aten_cpu_convs``: the training step's forward and backward run
  their CPU convolutions with oneDNN off, and the caller's flag comes back.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picopose_tpu.geom import affine as ja
from picopose_tpu.geom import projection as jproj
from picopose_tpu_torch import device
from picopose_tpu_torch.geom import affine as ta
from picopose_tpu_torch.geom import projection as tproj
from picopose_tpu_torch.geom.fma import apply_rows, fma32


def _round_f32(x: Fraction) -> np.float32:
    """The fp32 nearest to ``x``, ties to even, exactly."""
    near = np.float32(float(x))
    cands = {near, np.nextafter(near, np.float32(np.inf)), np.nextafter(near, np.float32(-np.inf))}
    best = min(cands, key=lambda f: (abs(Fraction(float(f)) - x), int(np.array(f).view(np.uint32)) & 1))
    return np.float32(best)


def test_fma32_rounds_once():
    rng = np.random.default_rng(0)
    a = rng.normal(size=4000).astype(np.float32)
    b = (rng.normal(size=4000) * 2.0 ** rng.integers(-20, 20, 4000)).astype(np.float32)
    c = rng.normal(size=4000).astype(np.float32)
    # c also set so that a * b + c sits on or next to a tie of fp32 rounding
    # after fp64 rounding, where rounding twice would err
    c[::2] = (-(a[::2].astype(np.float64) * b[::2]) + np.float64(2.0) ** -30).astype(np.float32)
    got = fma32(*map(torch.from_numpy, (a, b, c))).numpy()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_apply_rows_is_the_jax_cpu_einsum(rng):
    B, N = 4, 2048
    t = torch.from_numpy
    M = (rng.normal(size=(B, 3, 3)) * 10).astype(np.float32)
    K = np.tile(np.array([[572.4, 0, 325.2], [0, 573.5, 242.0], [0, 0, 1]], np.float32), (B, 1, 1))
    T = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    T[:, :3, :3] = np.linalg.qr(rng.normal(size=(B, 3, 3)))[0]
    T[:, :3, 3] = rng.normal(size=(B, 3)) * 0.2
    pts = rng.uniform(0, 200, (B, N, 2)).astype(np.float32)
    p3 = np.stack([rng.uniform(-0.1, 0.1, (B, N)), rng.uniform(-0.1, 0.1, (B, N)),
                   rng.uniform(0.3, 0.9, (B, N))], -1).astype(np.float32)
    pairs = [
        (ta.apply_affine(t(M), t(pts)), ja.apply_affine(M, pts)),
        (tproj.project_points(t(p3), t(K)), jproj.project_points(p3, K)),
        (tproj.transform_points(t(T), t(p3)), jproj.transform_points(T, p3)),
        (tproj.unproject_points(t(pts), t(K), t(p3[..., 2].reshape(B, 32, 64))),
         jproj.unproject_points(pts, K, p3[..., 2].reshape(B, 32, 64))),
    ]
    for i, (got, ref) in enumerate(pairs):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref), err_msg=f"function {i}")
    ref = np.asarray(jnp.einsum("...ij,...nj->...ni", M, p3, precision="highest"))
    np.testing.assert_array_equal(apply_rows(t(M), t(p3)).numpy(), ref)


def test_apply_rows_is_matmul_under_autograd(rng):
    M = torch.from_numpy(rng.normal(size=(2, 3, 3)).astype(np.float32)).requires_grad_()
    x = torch.from_numpy(rng.normal(size=(2, 5, 3)).astype(np.float32))
    y = apply_rows(M, x)
    assert torch.equal(y, torch.matmul(x, M.transpose(-1, -2)))
    y.sum().backward()
    torch.testing.assert_close(M.grad, x.sum(1)[:, None, :].expand(2, 3, 3))


@pytest.mark.parametrize("enabled", [True, False])
def test_aten_cpu_convs_restores_the_flag(enabled):
    saved = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = enabled
    try:
        with device.aten_cpu_convs():
            assert not torch.backends.mkldnn.enabled
        assert torch.backends.mkldnn.enabled is enabled
        with pytest.raises(RuntimeError), device.aten_cpu_convs():
            raise RuntimeError
        assert torch.backends.mkldnn.enabled is enabled
    finally:
        torch.backends.mkldnn.enabled = saved


def test_training_step_convolves_off_onednn(monkeypatch):
    """Every convolution of a training step, forward and backward, runs
    with oneDNN off (a vit_tiny_test step on two sphere pairs)."""
    from test_torch_train_step import OPT, _batch
    from torch_parity import SMALL

    from picopose_tpu_torch.train import step as ts
    from picopose_tpu_torch.train.augment import draw_affine_noise

    seen = []
    real = torch.nn.functional.conv2d

    def conv2d(*a, **kw):
        seen.append(torch.backends.mkldnn.enabled)
        return real(*a, **kw)

    monkeypatch.setattr(torch.nn.functional, "conv2d", conv2d)
    state = ts.init_state(ts.make_optimizer(**OPT), device="cpu", **SMALL, compute_dtype=torch.float32)
    backward = []
    state.model.dpt_head.resize_3.register_full_backward_hook(lambda *a: backward.append(torch.backends.mkldnn.enabled))
    ts.train_step(state, _batch(), draw_affine_noise(2, torch.Generator().manual_seed(0)))
    assert seen and not any(seen)
    assert backward and not any(backward)
    assert torch.backends.mkldnn.enabled
