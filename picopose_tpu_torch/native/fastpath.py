"""ctypes wrappers of the C++ host data path (csrc/fastpath.cpp).

The port's counterpart of picopose_tpu/native/fastpath.py (:31-105): the
RLE decode, the mask box, the rgb crop (crop, optional BGR flip, bilinear
resize with cv2.INTER_LINEAR's taps, CLIP normalisation) and the nearest
mask crop.  data/rle.py and data/crops.py dispatch the RLE decode and the
rgb crop here unless ``PICOPOSE_NO_FASTPATH=1`` asks for their numpy
paths; ``mask_bbox`` and ``crop_mask_nearest`` are bound for callers that
want them, as in the JAX package, where no loader calls them.
"""

from __future__ import annotations

import os

import numpy as np

from picopose_tpu_torch.native import call, load_library, ptr

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def accelerated() -> bool:
    """Take the C++ path?  False only under ``PICOPOSE_NO_FASTPATH=1`` (the
    JAX package's switch); otherwise the library is built if need be, and a
    failed build raises."""
    if os.environ.get("PICOPOSE_NO_FASTPATH"):
        return False
    load_library()
    return True


def rle_to_mask(rle: dict) -> np.ndarray:
    """COCO RLE (compressed or raw counts) -> (h, w) uint8 mask."""
    h, w = (int(v) for v in rle["size"])
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        s = counts.encode("ascii") if isinstance(counts, str) else counts
        buf = np.zeros(len(s) + 1, np.int64)
        n = call("rle_decode_counts", s, len(s), ptr(buf), len(buf))
        counts = buf[:n]
    counts = np.ascontiguousarray(counts, np.int64)
    mask = np.zeros((h, w), np.uint8)
    call("rle_counts_to_mask", ptr(counts), len(counts), h, w, ptr(mask))
    return mask


def mask_bbox(mask: np.ndarray) -> tuple[int, int, int, int] | None:
    """(y1, y2, x1, x2) of the mask's nonzero pixels, y2/x2 exclusive; None
    for an empty mask."""
    m = np.ascontiguousarray(mask, np.uint8)
    bbox = np.zeros(4, np.int32)
    ok = call("mask_bbox", ptr(m), m.shape[0], m.shape[1], ptr(bbox))
    return tuple(int(v) for v in bbox) if ok else None


def crop_resize_normalize(
    img: np.ndarray, bbox, out: int,
    mask: np.ndarray | None = None, mask_rgb: bool = False,
    bgr_flip: bool = True,
) -> np.ndarray:
    """uint8 (H, W, 3) -> normalised float32 (out, out, 3)."""
    img = np.ascontiguousarray(img, np.uint8)
    y1, y2, x1, x2 = (int(v) for v in bbox)
    out = int(out)
    dst = np.zeros((out, out, 3), np.float32)
    if mask is not None:
        mask = np.ascontiguousarray(mask, np.uint8)
    call("crop_resize_normalize", ptr(img), img.shape[0], img.shape[1], y1, y2, x1, x2,
         out, int(bgr_flip), int(mask_rgb), ptr(mask), ptr(CLIP_MEAN), ptr(CLIP_STD), ptr(dst))
    return dst


def crop_mask_nearest(mask: np.ndarray, bbox, out: int) -> np.ndarray:
    """uint8 (H, W) mask -> (out, out) float32 crop, nearest samples."""
    mask = np.ascontiguousarray(mask, np.uint8)
    y1, y2, x1, x2 = (int(v) for v in bbox)
    out = int(out)
    dst = np.zeros((out, out), np.float32)
    call("crop_mask_nearest", ptr(mask), mask.shape[0], mask.shape[1], y1, y2, x1, x2, out, ptr(dst))
    return dst
