"""ctypes wrappers of the zstd decoder and CRC32C (csrc/zstd.cpp).

The orbax checkpoint reader (utils/ocdbt.py, utils/zarr2.py) decodes every
OCDBT node and zarr chunk through ``zstd_decompress``.  There is no Python
decoder to fall back to: without the host library (no compiler, a failed
build) the call raises with the build's error, and
``PICOPOSE_NO_FASTPATH=1``, which picks the numpy crops, does not apply
here.  ctypes releases the GIL for the call, so threads decode chunks in
parallel.
"""

from __future__ import annotations

import ctypes

import numpy as np

from picopose_tpu_torch.native import call, ptr


class ZstdError(ValueError):
    """Malformed zstd input, or output larger than the capacity given."""


def _bytes(src) -> np.ndarray:
    a = src if isinstance(src, np.ndarray) else np.frombuffer(src, np.uint8)
    return np.ascontiguousarray(a.reshape(-1).view(np.uint8))


def zstd_decompress(src, dst_capacity: int, out: np.ndarray | None = None) -> np.ndarray:
    """Decode the zstd frames in ``src`` (bytes-like or a uint8 array; skippable
    frames are skipped) into at most ``dst_capacity`` bytes; returns a uint8
    array of the bytes written (a view of ``out`` when given, which must
    hold ``dst_capacity`` bytes and be contiguous).  Raises ZstdError with
    the input's byte offset on malformed input or when the output does not
    fit."""
    s = _bytes(src)
    if out is None:
        out = np.empty(int(dst_capacity), np.uint8)
    elif out.nbytes < dst_capacity or not out.flags.c_contiguous:
        raise ValueError(f"out holds {out.nbytes} bytes (contiguous: {out.flags.c_contiguous}), "
                         f"dst_capacity is {dst_capacity}")
    dst = out.reshape(-1).view(np.uint8)
    err = ctypes.create_string_buffer(512)
    n = call("zstd_decompress", ptr(s), s.size, ptr(dst), int(dst_capacity), err, len(err))
    if n < 0:
        raise ZstdError(f"zstd frame at byte {err.value.decode(errors='replace')}")
    return dst[:n]


CENSUS = ("frame", "single_segment", "fcs0", "fcs1", "fcs2", "fcs4", "fcs8", "dict_id_zero", "checksum",
          "skippable", "block_raw", "block_rle", "block_compressed", "lit_raw", "lit_rle", "lit_huf1", "lit_huf4",
          "lit_treeless", "huf_direct", "huf_fse", "seq_none", "table_predefined", "table_rle", "table_fse",
          "table_repeat", "rep_offset", "rep_shifted")


def census() -> dict[str, int]:
    """What the decoder has met since the last call (frames, header fields,
    block, literals and table kinds, repeat offsets, the shifted ones under
    a zero literal length), by ``CENSUS`` name; resets the counts."""
    out = np.zeros(len(CENSUS), np.int64)
    n = call("zstd_census", ptr(out), len(CENSUS))
    if n != len(CENSUS):
        raise RuntimeError(f"the library counts {n} features, this module names {len(CENSUS)}")
    return dict(zip(CENSUS, (int(v) for v in out)))


def crc32c(data) -> int:
    """CRC32C (Castagnoli) of ``data``."""
    s = _bytes(data)
    return int(call("crc32c", ptr(s), s.size))
