"""COCO RLE mask decoding.

The port's own copy of picopose_tpu/data/rle.py (``decode_compressed_counts``
:16, ``rle_to_mask`` :38, ``rle_to_mask_py`` :53).  ``rle_to_mask`` decodes
in C++ (native/fastpath.py); under ``PICOPOSE_NO_FASTPATH=1`` it takes the
numpy path ``rle_to_mask_py``, its oracle.  Both encodings of CNOS
detection files are read:
compressed (counts as COCO's LEB128-style ascii string) and uncompressed
(counts as a list of run lengths).  Masks are column-major, per the COCO
spec.
"""

from __future__ import annotations

import numpy as np

from picopose_tpu_torch.native import fastpath


def decode_compressed_counts(s: str | bytes) -> list[int]:
    """COCO's modified LEB128: 6 bits per char, offset 48, sign-extended,
    with delta coding from the count two positions back."""
    if isinstance(s, str):
        s = s.encode("ascii")
    counts: list[int] = []
    i = 0
    while i < len(s):
        x, k, more = 0, 0, True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k + 5)
            k += 1
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def rle_to_mask(rle: dict) -> np.ndarray:
    """{'size': [h, w], 'counts': str | list} -> (h, w) uint8 mask, in C++
    unless ``PICOPOSE_NO_FASTPATH=1``."""
    if fastpath.accelerated():
        return fastpath.rle_to_mask(rle)
    return rle_to_mask_py(rle)


def rle_to_mask_py(rle: dict) -> np.ndarray:
    """The numpy decode (the C++ path's oracle)."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = decode_compressed_counts(counts)
    counts = np.asarray(counts, dtype=np.int64)
    flat = np.zeros(h * w, dtype=np.uint8)
    ends = np.cumsum(counts)
    starts = ends - counts
    for s, e in zip(starts[1::2], ends[1::2]):  # odd runs are foreground
        flat[s:e] = 1
    return flat[: h * w].reshape((w, h)).T  # column-major
