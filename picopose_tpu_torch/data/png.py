"""PNG decoding and encoding on the standard library's zlib and numpy.

The port's counterpart of picopose_tpu/data/bop.py::_load_im (:56), which
decodes through PIL; the port does not depend on PIL.  Read: 8-bit grey,
RGB and RGBA, and 16-bit grey (big-endian samples, returned as native
``uint16``): BOP frames, template RGBA views and 16-bit depth maps.  The
arrays are those ``np.asarray(PIL.Image.open(path))`` gives: (H, W) for
grey, (H, W, 3|4) for colour.  Interlaced, palette, grey+alpha, 16-bit
colour and sub-byte files raise ``NotImplementedError`` naming the file, and
so do JPEG and TIFF paths; a bad CRC or a truncated stream raises
``ValueError``.

Write (``encode_png``, ``write_png``): the same four formats, every row
with filter 0 (None) in one zlib stream, in the port's stead of the JAX
package's ``imageio.imwrite`` (picopose_tpu/native/renderer.py:484-485).

Scanline filters (PNG spec 9.2, per byte, ``a`` the byte one pixel to the
left, ``b`` the byte above, ``c`` the byte above ``a``): None, Sub (+a),
Up (+b), Average (+floor((a + b) / 2)) and Paeth (+the nearest of a, b, c
to a + b - c).  Average and Paeth are sequential along a row and need the
row above, so the image is reconstructed over wavefronts: row y runs
``d(y)`` steps behind the start, where ``d`` restarts at 0 on a None or
Sub row (which read nothing above) and grows by one on each Up, Average or
Paeth row, and step t computes pixel t - d(y) of every row at once.  With
the rows stored skewed by ``d`` and steps outermost, each step reads and
writes contiguous (H, bpp) slices, and the image takes W + max(d) steps
of whole-array numpy operations instead of W x H per-pixel ones.  Each
step looks the predictors of all five filters up in one table keyed by
(type, b - c, a - c).
"""

from __future__ import annotations

import functools
import os
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (colour type, bit depth) -> channels, for the formats read here
_CHANNELS = {(0, 8): 1, (2, 8): 3, (6, 8): 4, (0, 16): 1}
_COLOUR_NAMES = {0: "grey", 2: "RGB", 3: "palette", 4: "grey+alpha", 6: "RGBA"}


def _chunks(buf: bytes, path: str):
    """(type, data) of each chunk, CRCs checked."""
    if buf[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 12 <= len(buf):
        (length,) = struct.unpack(">I", buf[pos : pos + 4])
        kind = buf[pos + 4 : pos + 8]
        end = pos + 8 + length
        if end + 4 > len(buf):
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        data = buf[pos + 8 : end]
        (crc,) = struct.unpack(">I", buf[end : end + 4])
        if zlib.crc32(kind + data) != crc:
            raise ValueError(f"{path}: CRC mismatch in {kind!r} chunk")
        yield kind, data
        if kind == b"IEND":
            return
        pos = end + 4
    raise ValueError(f"{path}: no IEND chunk")


@functools.lru_cache(maxsize=1)
def _delta_table() -> np.ndarray:
    """Each filter's predictor minus c, flat int32, at key
    ((type * 512 + b - c + 256) * 512 + a - c + 256); None's entries are
    unused (its rows are masked)."""
    p = np.arange(-256, 256)[:, None]  # b - c
    q = np.arange(-256, 256)[None, :]  # a - c
    pa, pb, pc = np.abs(p), np.abs(q), np.abs(p + q)  # |P - a|, |P - b|, |P - c| for P = a + b - c
    paeth = np.where((pa <= pb) & (pa <= pc), q, np.where(pb <= pc, p, 0))
    zero = np.zeros((512, 512), np.int64)
    return np.stack([zero, q + zero, p + zero, (p + q) >> 1, paeth]).astype(np.int32).reshape(-1)


def _unfilter(ftype: np.ndarray, f: np.ndarray) -> np.ndarray:
    """Undo the five filters in any mix, over wavefronts (module docstring)."""
    H, W, bpp = f.shape
    d = np.zeros(H, np.int64)
    for y in range(1, H):
        d[y] = d[y - 1] + 1 if ftype[y] >= 2 else 0
    steps = W + int(d.max())
    # skewed and step-major: S[s, y + 1] holds pixel s - 2 - d(y) of row y,
    # under a zero row (the row above row 0) and after two zero slots (a
    # and c left of pixel 0); F[t, y] holds row y's filtered pixel t - d(y).
    # Slots left of a row's pixel 0 stay 0 (their inputs are all 0); slots
    # right of its last pixel are never read by a pixel of the image.
    S = np.empty((steps + 2, H + 1, bpp), np.int32)
    F = np.empty((steps, H, bpp), np.int32)
    S.fill(0)  # zeroed here, not page by page inside the loop
    F.fill(0)
    for y in range(H):
        F[d[y] : d[y] + W, y] = f[y]
    full = lambda v: np.ascontiguousarray(np.broadcast_to(v[:, None], (H, bpp)), np.int32)
    base = full((ftype.astype(np.int32) * 512 + 256) * 512 + 256)
    keep = full(ftype != 0) if (ftype == 0).any() else None  # None rows: predictor 0
    table = _delta_table()
    key, pred = np.empty((H, bpp), np.int32), np.empty((H, bpp), np.int32)
    for t in range(steps):
        a, b, c = S[t + 1, 1:], S[t + 1, :-1], S[t, :-1]
        np.subtract(b, c, out=key)
        np.subtract(a, c, out=pred)
        key <<= 9
        key += pred
        key += base
        np.take(table, key, out=pred, mode="clip")
        pred += c
        if keep is not None:
            pred *= keep
        pred += F[t]
        np.bitwise_and(pred, 255, out=S[t + 2, 1:])
    out = np.empty((H, W, bpp), np.uint8)
    for y in range(H):
        out[y] = S[d[y] + 2 : d[y] + 2 + W, y + 1]
    return out


def decode_png(buf: bytes, path: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> the array PIL gives for them (module docstring)."""
    header, idat = None, []
    for kind, data in _chunks(buf, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, colour, _compression, _filter, interlace = header
    if interlace:
        raise NotImplementedError(f"{path}: interlaced PNG is not supported")
    if (colour, depth) not in _CHANNELS:
        raise NotImplementedError(
            f"{path}: {depth}-bit {_COLOUR_NAMES.get(colour, colour)} PNG is not supported"
        )
    bpp = _CHANNELS[colour, depth] * depth // 8
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt image data ({e})") from None
    if len(raw) < H * (1 + W * bpp):
        raise ValueError(f"{path}: image data too short")
    rows = np.frombuffer(raw, np.uint8, H * (1 + W * bpp)).reshape(H, 1 + W * bpp)
    ftype = rows[:, 0]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown scanline filter {int(ftype.max())}")
    f = rows[:, 1:].reshape(H, W, bpp)
    # every row None (what encode_png writes): the bytes are the pixels
    px = _unfilter(ftype, f) if ftype.any() else f.copy()
    if depth == 16:
        return px.reshape(H, W * 2).view(">u2").astype(np.uint16)
    return px[..., 0] if bpp == 1 else px


def read_png(path: str) -> np.ndarray:
    """Decode the PNG file at ``path``; JPEG and TIFF paths raise
    ``NotImplementedError`` (no decoder for them in the port yet)."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".jpg", ".jpeg", ".tif", ".tiff"):
        raise NotImplementedError(f"{path}: {ext} images are not supported (PNG only)")
    with open(path, "rb") as fh:
        return decode_png(fh.read(), path)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def encode_png(arr: np.ndarray) -> bytes:
    """(H, W) uint8 / uint16 grey, (H, W, 3) RGB or (H, W, 4) RGBA uint8 ->
    PNG bytes: filter 0 on every row, one IDAT chunk at zlib's default
    level (6, PIL's and so imageio's)."""
    arr = np.asarray(arr)
    if arr.ndim == 2 and arr.dtype in (np.uint8, np.uint16):
        colour, depth = 0, arr.dtype.itemsize * 8
    elif arr.ndim == 3 and arr.dtype == np.uint8 and arr.shape[2] in (3, 4):
        colour, depth = (2 if arr.shape[2] == 3 else 6), 8
    else:
        raise ValueError(f"cannot write a {arr.dtype} array of shape {arr.shape} as PNG")
    H, W = arr.shape[:2]
    rows = np.ascontiguousarray(arr, ">u2" if depth == 16 else np.uint8).view(np.uint8).reshape(H, -1)
    raw = np.concatenate([np.zeros((H, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", W, H, depth, colour, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, arr: np.ndarray) -> None:
    """Write ``arr`` to ``path`` as ``encode_png`` encodes it."""
    with open(path, "wb") as fh:
        fh.write(encode_png(arr))
