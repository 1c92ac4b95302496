"""Baseline uncompressed TIFF on numpy: ITODD's ``gray/*.tif`` test frames.

The JAX package reads them through PIL (picopose_tpu/data/bop.py:56-67);
the port does not depend on PIL.  Read: the first image of a classic TIFF
(``II`` or ``MM`` byte order), compression 1 (none), organised in strips,
BlackIsZero grey at 8 or 16 bits and chunky 8-bit RGB.  The arrays are
those ``np.asarray(PIL.Image.open(path))`` gives: (H, W) uint8 or uint16
for grey, (H, W, 3) uint8 for RGB; 16-bit samples come back as native
``uint16`` in either byte order.  Other compressions, tiles, planar RGB,
other photometric interpretations, sample formats, fill orders and bit
depths, predictors and BigTIFF raise ``NotImplementedError`` naming the
file and the tag; a truncated file raises ``ValueError``.

``encode_tiff`` writes the same kinds of file, in either byte order and
with any number of rows per strip.
"""

from __future__ import annotations

import struct

import numpy as np

SIGNATURES = (b"II*\x00", b"MM\x00*")

# tag numbers (TIFF 6.0, section 8)
WIDTH, HEIGHT, BITS, COMPRESSION, PHOTOMETRIC, FILL_ORDER = 256, 257, 258, 259, 262, 266
STRIP_OFFSETS, SAMPLES, ROWS_PER_STRIP, STRIP_BYTES = 273, 277, 278, 279
PLANAR, PREDICTOR, TILE_WIDTH, TILE_OFFSETS, SAMPLE_FORMAT = 284, 317, 322, 324, 339
TAG_NAMES = {
    COMPRESSION: "Compression", PHOTOMETRIC: "PhotometricInterpretation", FILL_ORDER: "FillOrder",
    BITS: "BitsPerSample", SAMPLES: "SamplesPerPixel", PLANAR: "PlanarConfiguration",
    PREDICTOR: "Predictor", TILE_WIDTH: "TileWidth", TILE_OFFSETS: "TileOffsets",
    SAMPLE_FORMAT: "SampleFormat",
}
# field type -> (struct code, size)
_TYPES = {1: ("B", 1), 2: ("c", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8), 6: ("b", 1),
          7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8), 11: ("f", 4), 12: ("d", 8)}


def _ifd(buf: bytes, path: str) -> tuple[str, dict[int, tuple]]:
    """(byte order, {tag: values}) of the first image file directory."""
    if buf[:4] not in SIGNATURES:
        if buf[:2] in (b"II", b"MM") and len(buf) >= 4:
            raise NotImplementedError(f"{path}: BigTIFF or unknown TIFF version is not supported")
        raise ValueError(f"{path}: not a TIFF file")
    if len(buf) < 8:
        raise ValueError(f"{path}: truncated TIFF header")
    bo = "<" if buf[:2] == b"II" else ">"
    (pos,) = struct.unpack(bo + "I", buf[4:8])
    if pos + 2 > len(buf):
        raise ValueError(f"{path}: truncated TIFF (no image file directory)")
    (n,) = struct.unpack(bo + "H", buf[pos : pos + 2])
    if pos + 2 + 12 * n > len(buf):
        raise ValueError(f"{path}: truncated TIFF directory")
    tags = {}
    for i in range(n):
        entry = buf[pos + 2 + 12 * i : pos + 14 + 12 * i]
        tag, kind, count = struct.unpack(bo + "HHI", entry[:8])
        if kind not in _TYPES:
            continue
        code, size = _TYPES[kind]
        nbytes = size * count
        if nbytes <= 4:
            data = entry[8 : 8 + nbytes]
        else:
            (off,) = struct.unpack(bo + "I", entry[8:12])
            if off + nbytes > len(buf):
                raise ValueError(f"{path}: truncated TIFF (tag {tag} data)")
            data = buf[off : off + nbytes]
        tags[tag] = struct.unpack(bo + code * count, data) if kind != 2 else (data,)
    return bo, tags


def _refuse(path: str, tag: int, value) -> None:
    raise NotImplementedError(f"{path}: TIFF {TAG_NAMES.get(tag, tag)} (tag {tag}) = {value} is not supported")


def decode_tiff(buf: bytes, path: str = "<bytes>") -> np.ndarray:
    """TIFF bytes -> the array PIL gives for them (module docstring)."""
    bo, tags = _ifd(buf, path)
    get = lambda tag, default: tags.get(tag, (default,))
    if TILE_WIDTH in tags or TILE_OFFSETS in tags:
        _refuse(path, TILE_OFFSETS if TILE_OFFSETS in tags else TILE_WIDTH, "tiled")
    for tag, allowed, default in ((COMPRESSION, (1,), 1), (PREDICTOR, (1,), 1), (FILL_ORDER, (1,), 1),
                                  (PLANAR, (1,), 1), (SAMPLE_FORMAT, (1,), 1)):
        values = get(tag, default)
        if any(v not in allowed for v in values):
            _refuse(path, tag, values[0] if len(set(values)) == 1 else values)
    if WIDTH not in tags or HEIGHT not in tags or STRIP_OFFSETS not in tags:
        raise ValueError(f"{path}: TIFF without ImageWidth, ImageLength or StripOffsets")
    W, H = tags[WIDTH][0], tags[HEIGHT][0]
    spp = get(SAMPLES, 1)[0]
    bits = get(BITS, 1)
    photometric = get(PHOTOMETRIC, None)[0]
    if spp == 1 and photometric == 1 and bits[0] in (8, 16):
        depth = bits[0]
    elif spp == 3 and photometric == 2 and tuple(bits) == (8, 8, 8):
        depth = 8
    elif spp not in (1, 3):
        _refuse(path, SAMPLES, spp)
    elif photometric not in ((1,) if spp == 1 else (2,)):
        _refuse(path, PHOTOMETRIC, photometric)
    else:
        _refuse(path, BITS, bits if len(bits) > 1 else bits[0])
    offsets, counts = tags[STRIP_OFFSETS], tags.get(STRIP_BYTES)
    rows = min(get(ROWS_PER_STRIP, H)[0], H)
    row_bytes = W * spp * depth // 8
    need = H * row_bytes
    parts, have = [], 0
    for i, off in enumerate(offsets):
        take = min(rows * row_bytes, need - have)
        if counts is not None:
            take = min(take, counts[i])
        if take <= 0:
            break
        if off + take > len(buf):
            raise ValueError(f"{path}: truncated TIFF (strip {i})")
        parts.append(buf[off : off + take])
        have += take
    if have < need:
        raise ValueError(f"{path}: TIFF strips hold {have} of {need} image bytes")
    px = np.frombuffer(b"".join(parts), np.dtype(bo + ("u1" if depth == 8 else "u2")))
    px = px.astype(np.uint16) if depth == 16 else px.copy()
    return px.reshape(H, W) if spp == 1 else px.reshape(H, W, 3)


def encode_tiff(arr: np.ndarray, big_endian: bool = False, rows_per_strip: int | None = None) -> bytes:
    """(H, W) uint8 / uint16 grey or (H, W, 3) uint8 RGB -> uncompressed
    TIFF bytes, the strips after the header and the directory at the end."""
    arr = np.asarray(arr)
    if not ((arr.ndim == 2 and arr.dtype in (np.uint8, np.uint16))
            or (arr.ndim == 3 and arr.shape[2] == 3 and arr.dtype == np.uint8)):
        raise ValueError(f"cannot write a {arr.dtype} array of shape {arr.shape} as TIFF")
    bo = ">" if big_endian else "<"
    H, W = arr.shape[:2]
    spp = 1 if arr.ndim == 2 else 3
    depth = arr.dtype.itemsize * 8
    rows = H if rows_per_strip is None else max(1, min(rows_per_strip, H))
    data = np.ascontiguousarray(arr, arr.dtype.newbyteorder(bo)).tobytes()
    row_bytes = W * spp * depth // 8
    offsets, counts = [], []
    for y in range(0, H, rows):
        offsets.append(8 + y * row_bytes)
        counts.append(min(rows, H - y) * row_bytes)
    extra = b""  # out-of-line tag values after the directory
    n_tags = 10
    ifd_at = 8 + len(data) + (len(data) & 1)
    extra_at = ifd_at + 2 + 12 * n_tags + 4

    def entry(tag, kind, values):
        nonlocal extra
        code, size = _TYPES[kind]
        payload = struct.pack(bo + code * len(values), *values)
        if len(payload) <= 4:
            field = payload.ljust(4, b"\x00")
        else:
            field = struct.pack(bo + "I", extra_at + len(extra))
            extra += payload
        return struct.pack(bo + "HHI", tag, kind, len(values)) + field

    entries = [
        entry(WIDTH, 4, [W]), entry(HEIGHT, 4, [H]), entry(BITS, 3, [depth] * spp),
        entry(COMPRESSION, 3, [1]), entry(PHOTOMETRIC, 3, [1 if spp == 1 else 2]),
        entry(STRIP_OFFSETS, 4, offsets), entry(SAMPLES, 3, [spp]), entry(ROWS_PER_STRIP, 4, [rows]),
        entry(STRIP_BYTES, 4, counts), entry(PLANAR, 3, [1]),
    ]
    head = (b"II*\x00" if not big_endian else b"MM\x00*") + struct.pack(bo + "I", ifd_at)
    ifd = struct.pack(bo + "H", n_tags) + b"".join(entries) + struct.pack(bo + "I", 0)
    return head + data + b"\x00" * (len(data) & 1) + ifd + extra
