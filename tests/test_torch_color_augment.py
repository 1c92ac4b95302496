"""The port's colour augmentation (picopose_tpu_torch/data/color_augment.py)
against the JAX package's (picopose_tpu/data/color_augment.py), which runs
four of its ops through PIL and three through cv2.

Each op and the whole ``augment_color`` get the same uint8 image and a
generator in the same state on both sides.  Tolerance: bitwise equal
images (GaussianBlur too: cv2's fixed-point path is written out with its
kernel rounding), and equal generator states afterwards, so the next draw
is the same.
"""

import numpy as np
import pytest

from picopose_tpu.data import color_augment as J
from picopose_tpu_torch.data import color_augment as T

OPS = ("_coarse_dropout", "_gaussian_blur", "_sharpness", "_contrast_enhance", "_brightness",
       "_color_enhance", "_add", "_invert", "_multiply_per_channel", "_multiply", "_gauss_noise",
       "_linear_contrast", "_grayscale_blend")


def _crops(seed, n):
    """Random uint8 crops of random sizes; every third a low-contrast one
    (the enhance ops' degenerate images differ most there)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        H, W = rng.integers(20, 120, 2)
        x = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
        if i % 3 == 0:
            x = (x // 4 + 100).astype(np.uint8)
        out.append(x)
    return out


@pytest.mark.parametrize("op", OPS)
def test_each_op_is_the_jax_op(op):
    for trial, x in enumerate(_crops(OPS.index(op), 40)):
        r_jax, r_port = np.random.default_rng(trial), np.random.default_rng(trial)
        ref = getattr(J, op)(r_jax, x)
        got = getattr(T, op)(r_port, x)
        assert got.dtype == ref.dtype == np.uint8 and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref, err_msg=f"{op} trial {trial}")
        assert r_port.bit_generator.state == r_jax.bit_generator.state, f"{op} trial {trial}"


@pytest.mark.parametrize("sigma", [0.3, 0.7, 1.3, 1.9, 2.2, 2.9])
def test_gaussian_blur_kernels(sigma):
    """Every kernel size the op uses (5, 7, 9), on a crop smaller than the
    kernel is wide at its border."""
    import cv2

    x = _crops(7, 1)[0]
    k = J._gaussian_blur_ksize(sigma)
    np.testing.assert_array_equal(T._gaussian_blur_cv2(x, k, sigma),
                                  cv2.GaussianBlur(x, (k, k), sigmaX=sigma, sigmaY=sigma))


def test_augment_color_over_50_seeds():
    crops = _crops(99, 50)
    for seed, x in enumerate(crops):
        r_jax, r_port = np.random.default_rng(seed), np.random.default_rng(seed)
        np.testing.assert_array_equal(T.augment_color(r_port, x), J.augment_color(r_jax, x), err_msg=f"seed {seed}")
        assert r_port.bit_generator.state == r_jax.bit_generator.state, f"seed {seed}"
