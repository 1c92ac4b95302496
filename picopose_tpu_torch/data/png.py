"""PNG decoding and encoding on the standard library's zlib and numpy.

The port's counterpart of picopose_tpu/data/bop.py::_load_im (:56), which
decodes through PIL; the port does not depend on PIL.  Read: every colour
type at every bit depth the PNG spec allows, interlaced (Adam7) or not:
BOP frames, template RGBA views and 16-bit depth maps among them.  The
arrays are those ``np.asarray(PIL.Image.open(path))`` gives, with PIL's
modes: grey (H, W) uint8, 1-bit grey as bool (mode "1"), 2- and 4-bit
grey scaled to 0-255 (x 85, x 17), 16-bit grey native ``uint16``;
palette files (H, W) uint8 indices (mode "P"); grey+alpha (H, W, 2)
uint8, and at 16 bits (H, W, 4) RGBA (grey repeated); RGB (H, W, 3) and
RGBA (H, W, 4) uint8, 16-bit samples cut to their high byte.  Ancillary
chunks (PLTE, tRNS, gAMA, ...) change no sample.  JPEG and TIFF paths
raise ``NotImplementedError`` naming the file; a bad CRC or a truncated
stream raises ``ValueError``.

Write (``encode_png``, ``write_png``): 8-bit grey, RGB and RGBA and 16-bit
grey, every row with filter 0 (None) in one zlib stream, in the port's
stead of the JAX package's ``imageio.imwrite``
(picopose_tpu/native/renderer.py:484-485).

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
(type, b - c, a - c).  An interlaced file's seven Adam7 passes are seven
such images, unfiltered one after another and scattered into place;
sub-byte samples are filtered as bytes (bpp 1) and unpacked after.
"""

from __future__ import annotations

import functools
import os
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples per pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}  # PNG spec 11.2.2
_COLOUR_NAMES = {0: "grey", 2: "RGB", 3: "palette", 4: "grey+alpha", 6: "RGBA"}
# Adam7: (first row, first column, row step, column step) of each pass
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


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


def _pass_pixels(raw: np.ndarray, H: int, W: int, depth: int, spp: int, path: str) -> np.ndarray:
    """One (pass) image's filtered rows -> (H, W, spp) samples: uint8, or
    uint16 at 16 bits; sub-byte samples unpacked, unscaled."""
    row_bytes = -(-W * spp * depth // 8)
    bpp = max(1, spp * depth // 8)
    rows = raw.reshape(H, 1 + row_bytes)
    ftype = rows[:, 0]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown scanline filter {int(ftype.max())}")
    f = rows[:, 1:].reshape(H, row_bytes // bpp, bpp)
    # every row None (what encode_png writes): the bytes are the pixels
    px = (_unfilter(ftype, f) if ftype.any() else f.copy()).reshape(H, row_bytes)
    if depth == 16:
        return px.view(">u2").astype(np.uint16).reshape(H, W, spp)
    if depth < 8:  # MSB-first samples, each row padded to a byte
        bits = np.unpackbits(px, axis=1)[:, : W * depth].reshape(H, W, depth)
        px = (bits.astype(np.uint8) << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(-1, dtype=np.uint8)
    return px.reshape(H, W, spp)


def decode_png(buf: bytes, path: str = "<bytes>", palette: bool = False) -> np.ndarray:
    """PNG bytes -> the array PIL gives for them (module docstring); with
    ``palette``, a palette file's (H, W, 3) uint8 colours through its PLTE
    (entries past it black), as imageio reads it."""
    header, idat, plte = None, [], b""
    for kind, data in _chunks(buf, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"PLTE":
            plte = data
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, colour, _compression, _filter, interlace = header
    if depth not in _DEPTHS.get(colour, ()):
        raise ValueError(f"{path}: {depth}-bit {_COLOUR_NAMES.get(colour, colour)} PNG is not a valid PNG")
    if interlace > 1:
        raise ValueError(f"{path}: unknown interlace method {interlace}")
    spp = _CHANNELS[colour]
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt image data ({e})") from None
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    sizes = [(-(-(H - y0) // dy), -(-(W - x0) // dx)) for y0, x0, dy, dx in passes]
    sizes = [(h, w) if h > 0 and w > 0 else (0, 0) for h, w in sizes]  # an empty pass has no bytes
    need = [h * (1 + -(-w * spp * depth // 8)) for h, w in sizes]
    if len(raw) < sum(need):
        raise ValueError(f"{path}: image data too short")
    if interlace:
        px = np.zeros((H, W, spp), np.uint16 if depth == 16 else np.uint8)
        at = 0
        for (y0, x0, dy, dx), (h, w), n in zip(passes, sizes, need):
            if n:
                px[y0::dy, x0::dx] = _pass_pixels(raw[at : at + n], h, w, depth, spp, path)
            at += n
    else:
        px = _pass_pixels(raw[: need[0]], H, W, depth, spp, path)
    if colour == 3 and palette:
        return colours(plte, px[..., 0])
    # PIL's modes (module docstring)
    if colour in (0, 3) and depth < 8:
        px = px[..., 0]
        if colour == 3:
            return px
        return px.astype(bool) if depth == 1 else px * np.uint8(255 // ((1 << depth) - 1))
    if depth == 16 and colour != 0:
        px = (px >> 8).astype(np.uint8)
        if colour == 4:
            return px[..., [0, 0, 0, 1]]
    return px[..., 0] if spp == 1 else px


def colours(rgb: bytes, index: np.ndarray) -> np.ndarray:
    """Palette indices -> (..., 3) uint8 colours of the palette ``rgb``
    (R, G, B bytes per entry), entries past its end black, as PIL pads it."""
    table = np.zeros((256, 3), np.uint8)
    n = min(len(rgb) // 3, 256)
    table[:n] = np.frombuffer(rgb[: 3 * n], np.uint8).reshape(n, 3)
    return table[index]


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
