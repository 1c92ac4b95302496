"""Colour augmentation of training crops, without cv2 or PIL.

The port's own copy of picopose_tpu/data/color_augment.py: ``augment_color``
and its 13 ops (:49-171), the reference's imgaug pipeline
(provider/training_dataset.py:88-105).  Every op draws from the
``np.random.Generator`` exactly as the JAX package's does (the same calls,
in the same order, with the same shapes), so one generator state gives one
output in both packages.  The ops the JAX package hands to PIL and cv2 are
written out with those libraries' integer and float32 arithmetic:

  * PIL ``ImageEnhance`` (Sharpness, Contrast, Brightness, Color):
    ``Image.blend(degenerate, image, factor)``, computed per byte as
    float32 ``in1 + alpha * (in2 - in1)`` and truncated, clipped to
    [0, 255] only when alpha lies outside [0, 1].  The degenerate images:
    Sharpness, the SMOOTH filter (3 x 3, centre 5, divisor 13: float32
    weights, rows summed bottom to top, rounded half up, the border
    pixels kept); Contrast, the L image's ``int(mean + 0.5)``; Color, the
    L image as RGB; Brightness, black.  ``convert("L")`` is
    ``(19595 R + 38470 G + 7471 B + 0x8000) >> 16``;
  * cv2 ``COLOR_RGB2GRAY`` on uint8: ``(9798 R + 19235 G + 3735 B +
    16384) >> 15``;
  * cv2 ``GaussianBlur`` on uint8: the bit-exact fixed-point path, the
    kernel in 8 fractional bits summing to exactly 1, the row pass exact
    in 16 bits, the column pass rounded from 32 bits to 8,
    BORDER_REFLECT_101;
  * cv2 ``INTER_NEAREST`` resize: data/crops.py::nearest_index.

Every op restores uint8 before the next runs (imgaug's round, clip, cast).
"""

from __future__ import annotations

import math

import numpy as np

from picopose_tpu_torch.data.crops import nearest_index


def _restore_uint8(x: np.ndarray) -> np.ndarray:
    """imgaug's per-op uint8 restore: round, clip, cast."""
    return np.clip(np.round(x), 0, 255).astype(np.uint8)


def _grey_pil(x: np.ndarray) -> np.ndarray:
    """PIL's convert("L") of a uint8 RGB image."""
    r, g, b = (x[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def _blend(degenerate: np.ndarray, img: np.ndarray, factor: float) -> np.ndarray:
    """PIL's Image.blend(degenerate, img, factor) on uint8 arrays."""
    alpha = np.float32(factor)
    a = degenerate.astype(np.float32)
    out = a + alpha * (img.astype(np.float32) - a)
    # PIL clips only when extrapolating; interpolation stays inside [0, 255]
    return np.clip(out, 0, 255).astype(np.uint8)


def _smooth_pil(x: np.ndarray) -> np.ndarray:
    """PIL's ImageFilter.SMOOTH (ImagingFilter3x3) on a uint8 RGB image."""
    H, W = x.shape[:2]
    out = x.copy()
    if H < 3 or W < 3:
        return out
    k = np.float32(1.0) / np.float32(13.0), np.float32(5.0) / np.float32(13.0)
    f = x.astype(np.float32)

    def row(r, centre):  # KERNEL1x3 on image row r, kernel row (1, centre, 1)
        return (f[r, :-2] * k[0] + f[r, 1:-1] * centre) + f[r, 2:] * k[0]

    ss = np.float32(0.0) + row(slice(2, None), k[0])  # the row below: kernel[0:3]
    ss = ss + row(slice(1, -1), k[1])  # the centre row: kernel[3:6]
    ss = ss + row(slice(0, -2), k[0])  # the row above: kernel[6:9]
    out[1:-1, 1:-1] = np.where(ss <= 0.0, 0, np.where(ss >= 255.0, 255, (ss.astype(np.float64) + 0.5).astype(np.int64)))
    return out


def _gaussian_kernel_q8(k: int, sigma: float) -> np.ndarray:
    """cv2's getGaussianKernelBitExact for uint8, in 8 fractional bits:
    exp(-x^2 / (2 sigma^2)) normalised in float64; the side taps are the
    differences of their running sum rounded (half to even), and the
    centre tap takes what is left of 1."""
    scale2 = -0.125 / (sigma * sigma)
    half = (k - 1) // 2
    values = [math.exp(float(x * x) * scale2) for x in range(1 - k, 1 - k + 2 * half, 2)]
    mul = 1.0 / (sum(values) * 2.0 + 1.0)
    running, side = 0.0, []
    for v in values:
        before = round(running * 256.0)
        running += v * mul
        side.append(round(running * 256.0) - before)
    return np.array(side + [256 - 2 * sum(side)] + side[::-1], np.int64)


def _gaussian_blur_cv2(x: np.ndarray, k: int, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur(x, (k, k), sigma, sigma) on uint8 (odd k)."""
    kern = _gaussian_kernel_q8(k, sigma)
    r = k // 2
    xp = np.pad(x.astype(np.int64), ((r, r), (r, r), (0, 0)), mode="reflect")  # BORDER_REFLECT_101
    H, W = x.shape[:2]
    rows = sum(kern[i] * xp[:, i : i + W] for i in range(k))  # Q8.8, exact
    acc = sum(kern[i] * rows[i : i + H] for i in range(k))  # Q16.16, exact
    return np.minimum((acc + (1 << 15)) >> 16, 255).astype(np.uint8)


def augment_color(rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
    """uint8 (H, W, 3) -> uint8; the full probabilistic pipeline.

    Mirrors Sequential([Sometimes(p_i, op_i) ...], random_order=True):
    ops run in a fresh random order per image, each gated by its own
    probability, each producing a uint8 image for the next.
    """
    x = np.ascontiguousarray(img).astype(np.uint8)

    ops = [
        (0.5, _coarse_dropout),
        (0.4, _gaussian_blur),
        (0.3, _sharpness),
        (0.3, _contrast_enhance),
        (0.5, _brightness),
        (0.3, _color_enhance),
        (0.5, _add),
        (0.3, _invert),
        (0.5, _multiply_per_channel),
        (0.5, _multiply),
        (0.1, _gauss_noise),
        (0.5, _linear_contrast),
        (0.5, _grayscale_blend),
    ]
    for i in rng.permutation(len(ops)):
        p, fn = ops[i]
        if rng.random() < p:
            x = fn(rng, x)
    return x


def _coarse_dropout(rng, x):
    # CoarseDropout(p=0.2, size_percent=0.05): bernoulli(0.2) mask sampled
    # at 5% resolution, nearest-upscaled, zeroing all channels.
    H, W = x.shape[:2]
    gh, gw = max(1, int(H * 0.05)), max(1, int(W * 0.05))
    drop = (rng.random((gh, gw)) < 0.2).astype(np.uint8)
    drop = drop[nearest_index(gh, H)][:, nearest_index(gw, W)]
    return x * (1 - drop[..., None])


def _gaussian_blur_ksize(sigma: float) -> int:
    # imgaug/augmenters/blur.py::_compute_gaussian_blur_ksize —
    # kernel covers ~99/97/95% of the gaussian mass by sigma range.
    if sigma < 3.0:
        ksize = 3.3 * sigma
    elif sigma < 5.0:
        ksize = 2.9 * sigma
    else:
        ksize = 2.6 * sigma
    k = int(max(ksize, 5))
    return k + 1 if k % 2 == 0 else k


def _gaussian_blur(rng, x):  # GaussianBlur((0., 3.))
    sigma = rng.uniform(0.0, 3.0)
    if sigma <= 1e-3:  # imgaug's zero-sigma epsilon gate
        return x
    return _gaussian_blur_cv2(x, _gaussian_blur_ksize(sigma), sigma)


def _sharpness(rng, x):  # pillike.EnhanceSharpness(factor=(0., 50.))
    return _blend(_smooth_pil(x), x, rng.uniform(0.0, 50.0))


def _contrast_enhance(rng, x):  # pillike.EnhanceContrast(factor=(0.2, 50.))
    grey = _grey_pil(x)
    mean = int(int(grey.sum(dtype=np.int64)) / grey.size + 0.5)
    return _blend(np.full_like(x, mean), x, rng.uniform(0.2, 50.0))


def _brightness(rng, x):  # pillike.EnhanceBrightness(factor=(0.1, 6.))
    return _blend(np.zeros_like(x), x, rng.uniform(0.1, 6.0))


def _color_enhance(rng, x):  # pillike.EnhanceColor(factor=(0., 20.))
    return _blend(np.repeat(_grey_pil(x)[..., None], 3, axis=-1), x, rng.uniform(0.0, 20.0))


def _add(rng, x):  # Add((-25, 25), per_channel=0.3): discrete ints, saturating
    if rng.random() < 0.3:
        v = rng.integers(-25, 26, size=(1, 1, 3))
    else:
        v = np.full((1, 1, 1), rng.integers(-25, 26))
    return _restore_uint8(x.astype(np.int16) + v)


def _invert(rng, x):  # Invert(0.2, per_channel=True)
    ch = rng.random(3) < 0.2
    out = x.copy()
    out[..., ch] = 255 - out[..., ch]
    return out


def _multiply_per_channel(rng, x):  # Multiply((0.6, 1.4), per_channel=0.5)
    if rng.random() < 0.5:
        f = rng.uniform(0.6, 1.4, size=(1, 1, 3))
    else:
        f = rng.uniform(0.6, 1.4)
    return _restore_uint8(x.astype(np.float32) * f)


def _multiply(rng, x):  # Multiply((0.6, 1.4))
    return _restore_uint8(x.astype(np.float32) * rng.uniform(0.6, 1.4))


def _gauss_noise(rng, x):  # AdditiveGaussianNoise(scale=10, per_channel=True)
    return _restore_uint8(x.astype(np.float32) + rng.normal(0.0, 10.0, x.shape))


def _linear_contrast(rng, x):  # LinearContrast((0.5, 2.2), per_channel=0.3)
    if rng.random() < 0.3:
        a = rng.uniform(0.5, 2.2, size=(1, 1, 3))
    else:
        a = rng.uniform(0.5, 2.2)
    # imgaug adjust_contrast_linear for uint8: 127 + alpha*(v - 127)
    return _restore_uint8(127.0 + a * (x.astype(np.float32) - 127.0))


def _grayscale_blend(rng, x):  # Grayscale(alpha=(0.0, 1.0))
    a = rng.uniform(0.0, 1.0)
    r, g, b = (x[..., i].astype(np.int32) for i in range(3))
    grey = ((r * 9798 + g * 19235 + b * 3735 + (1 << 14)) >> 15).astype(np.uint8)
    g3 = np.repeat(grey[..., None], 3, axis=-1).astype(np.float32)
    return _restore_uint8((1.0 - a) * x.astype(np.float32) + a * g3)
