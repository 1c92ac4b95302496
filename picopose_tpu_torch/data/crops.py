"""Square crops of a frame, normalised for the network (host side, numpy).

The port's own copy of picopose_tpu/data/crops.py without cv2, which the
GPU machine lacks: ``mask_square_bbox`` (:26), ``square_bbox`` /
``_squareize`` (:37-61), ``crop_matrix`` (:64), ``crop_and_normalize_rgb``
(:76-93) and ``crop_and_normalize_rgb_py`` (:96-107), ``crop_mask``
(:110), ``depth_to_points`` (:116) and ``grid_pts2d`` (:130).  As in the
JAX package, the rgb crop of a uint8 frame runs in C++
(native/fastpath.py, within 5e-4 of the numpy path) unless
``PICOPOSE_NO_FASTPATH=1``.  The numpy resizes are
written out with cv2's semantics as separable row matrices:

  * rgb, cv2.INTER_LINEAR: centre-aligned taps src = (dst + 0.5) * scale
    - 0.5, the first row/column replicated below 0 and the last one above
    size - 1 (border replicate inside the crop);
  * mask, cv2.INTER_NEAREST: src = floor(dst * (1 / (out / size))),
    clamped to size - 1, in float64 as cv2 computes it.

The rgb crop is flipped to BGR (unless ``bgr_flip=False``) and
CLIP-normalised, as the reference network consumes it.
"""

from __future__ import annotations

import numpy as np

from picopose_tpu_torch.native import fastpath

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def mask_square_bbox(mask: np.ndarray, size_ratio: float = 1.0) -> tuple[int, int, int, int]:
    """(y1, y2, x1, x2) square bbox around the mask, y2/x2 exclusive."""
    rows = np.any(mask, axis=1)
    cols = np.any(mask, axis=0)
    rmin, rmax = np.where(rows)[0][[0, -1]]
    cmin, cmax = np.where(cols)[0][[0, -1]]
    return square_bbox((rmin, rmax + 1, cmin, cmax + 1), mask.shape, size_ratio)


def square_bbox(bbox, img_hw, size_ratio: float = 1.0) -> tuple[int, int, int, int]:
    """Square a (y1, y2, x1, x2) box: side = min(max(h, w), min(H, W)) *
    ``size_ratio``, centred, then shifted inside the image in y-then-x
    order, once (the JAX package's ``_squareize``: a side past the image's
    stays past it)."""
    H, W = img_hw
    rmin, rmax, cmin, cmax = bbox
    b = min(max(rmax - rmin, cmax - cmin), min(H, W)) * size_ratio
    cy, cx = int((rmin + rmax) / 2), int((cmin + cmax) / 2)
    rmin, rmax = cy - int(b / 2), cy + int(b / 2)
    cmin, cmax = cx - int(b / 2), cx + int(b / 2)
    if rmin < 0:
        rmax += -rmin
        rmin = 0
    if cmin < 0:
        cmax += -cmin
        cmin = 0
    if rmax > H:
        rmin -= rmax - H
        rmax = H
    if cmax > W:
        cmin -= cmax - W
        cmax = W
    return int(rmin), int(rmax), int(cmin), int(cmax)


def crop_matrix(bbox, out: int) -> np.ndarray:
    """M mapping original-image (x, y) to crop coordinates for a square bbox."""
    y1, y2, x1, x2 = bbox
    M_crop = np.array([[1, 0, -x1], [0, 1, -y1], [0, 0, 1]], np.float32)
    M_resize = np.array(
        [[out / (y2 - y1), 0, 0], [0, out / (x2 - x1), 0], [0, 0, 1]], np.float32
    )
    return M_resize @ M_crop


def linear_rows(size: int, out: int) -> np.ndarray:
    """(out, size) float64 matrix of cv2.INTER_LINEAR's two taps per output
    sample, resizing ``size`` samples to ``out``."""
    src = (np.arange(out) + 0.5) * (size / out) - 0.5
    i0 = np.floor(src)
    w1 = src - i0
    w1[src < 0] = 0.0
    i0 = np.clip(i0, 0, size - 1).astype(np.int64)
    i1 = np.minimum(i0 + 1, size - 1)
    R = np.zeros((out, size))
    rows = np.arange(out)
    np.add.at(R, (rows, i0), 1.0 - w1)
    np.add.at(R, (rows, i1), w1)  # i1 == i0 at the last sample: the weights sum to 1
    return R


def nearest_index(size: int, out: int) -> np.ndarray:
    """(out,) source index of each output sample, cv2.INTER_NEAREST."""
    src = np.floor(np.arange(out) * (1.0 / (out / size))).astype(np.int64)
    return np.minimum(src, size - 1)


def crop_and_normalize_rgb(
    rgb: np.ndarray, bbox, out: int, mask: np.ndarray | None = None, mask_rgb: bool = False,
    bgr_flip: bool = True,
) -> np.ndarray:
    """(H, W, 3) RGB frame -> (out, out, 3) float32 crop, CLIP-normalised,
    flipped to BGR unless ``bgr_flip=False``: in C++ for a uint8 frame
    (native/fastpath.py) unless ``PICOPOSE_NO_FASTPATH=1``, else
    ``crop_and_normalize_rgb_py``."""
    if rgb.dtype == np.uint8 and fastpath.accelerated():
        return fastpath.crop_resize_normalize(rgb[..., :3], bbox, out, mask=mask, mask_rgb=mask_rgb,
                                              bgr_flip=bgr_flip)
    return crop_and_normalize_rgb_py(rgb, bbox, out, mask, mask_rgb, bgr_flip)


def crop_and_normalize_rgb_py(
    rgb: np.ndarray, bbox, out: int, mask: np.ndarray | None = None, mask_rgb: bool = False,
    bgr_flip: bool = True,
) -> np.ndarray:
    """The numpy crop with cv2.INTER_LINEAR's semantics (the C++ path's
    oracle)."""
    y1, y2, x1, x2 = bbox
    channels = slice(2, None, -1) if bgr_flip else slice(0, 3)
    patch = rgb[y1:y2, x1:x2, channels] / 255.0
    if mask_rgb and mask is not None:
        patch = patch * (mask[y1:y2, x1:x2, None] > 0)
    Ry, Rx = linear_rows(y2 - y1, out), linear_rows(x2 - x1, out)
    patch = np.einsum("yh,hwc,xw->yxc", Ry, patch, Rx, optimize=True)
    return ((patch - CLIP_MEAN) / CLIP_STD).astype(np.float32)


def crop_mask(mask: np.ndarray, bbox, out: int) -> np.ndarray:
    """(H, W) mask -> (out, out) float32 crop, nearest samples; values are
    truncated to integers first (a template's alpha / 255 keeps only its
    opaque pixels), as the JAX package's int32 resize does."""
    y1, y2, x1, x2 = bbox
    m = mask[y1:y2, x1:x2].astype(np.int32).astype(np.float32)
    return m[nearest_index(y2 - y1, out)][:, nearest_index(x2 - x1, out)]


def depth_to_points(depth: np.ndarray, K: np.ndarray, bbox=None) -> np.ndarray:
    """(H, W) depth -> (H', W', 3) camera points, cut to ``bbox`` if given."""
    H, W = depth.shape
    xs, ys = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    if bbox is not None:
        y1, y2, x1, x2 = bbox
        depth = depth[y1:y2, x1:x2]
        xs, ys = xs[y1:y2, x1:x2], ys[y1:y2, x1:x2]
    X = (xs - K[0, 2]) * depth / K[0, 0]
    Y = (ys - K[1, 2]) * depth / K[1, 1]
    return np.stack([X, Y, depth], axis=-1).astype(np.float32)


def grid_pts2d(M: np.ndarray, crop: int = 224, grid: int = 64) -> np.ndarray:
    """Original-image coordinates of the crop's patch-centre grid."""
    patch = crop / grid
    cs = (np.arange(grid) * patch + patch / 2.0).astype(np.float64)
    xx, yy = np.meshgrid(cs, cs)
    pts = np.stack([xx, yy, np.ones_like(xx)], -1) @ np.linalg.inv(M).T
    return (pts[..., :2] / pts[..., 2:]).astype(np.float32)
