"""TIFF decoding on numpy and zlib, and an uncompressed TIFF writer:
ITODD's ``gray/*.tif`` test frames, and the TIFFs PIL reads besides.

The JAX package reads them through PIL (picopose_tpu/data/bop.py:56-67),
which decodes a compressed file through libtiff and an uncompressed one
itself; the port depends on neither.  Read: the first image of a classic
or a BigTIFF file (``II`` or ``MM`` byte order), in strips or tiles,
chunky or planar (``PlanarConfiguration`` 2), uncompressed or compressed
with PackBits (32773), LZW (5) or Deflate (8 and 32946), with the
horizontal predictor (2) or the floating-point one (3).  The arrays are
those ``np.asarray(PIL.Image.open(path))`` gives, in PIL's modes:

  * grey (BlackIsZero, WhiteIsZero inverted, and 8-bit YCbCr's luma):
    1-bit as bool, 2- and 4-bit scaled to 0-255, 8-bit (H, W) uint8,
    12- and 16-bit unsigned uint16, signed 16-bit widened to int32, 32-bit
    int32 (unsigned ones as PIL reads them, bit for bit) or float32;
    grey + alpha (H, W, 2) uint8;
  * RGB (H, W, 3) and RGBA (H, W, 4) (unassociated alpha, none named
    with four samples, or associated alpha divided out as PIL's "RGBa"
    does), unspecified extra samples dropped; CMYK (H, W, 4); all uint8,
    16-bit samples cut to their high byte; palette (H, W) uint8 indices,
    (H, W, 2) with alpha.

Multi-byte samples come back in native byte order, except where PIL
swaps them: a compressed big-endian file's signed 16-bit, 32-bit integer
and float samples, which libtiff hands PIL in native order and PIL
unpacks as big-endian.  As PIL's own reader and libtiff's PackBits codec
do, an uncompressed or PackBits file's predictor tag is not applied.
JPEG-in-TIFF and the other compressions, FillOrder 2, 64-bit samples, and the sample
layouts PIL's table lacks (other photometric interpretations, big-endian
12-bit or unsigned 32-bit samples, ...) raise ``NotImplementedError``
naming the file and the tag; a truncated or corrupt file raises
``ValueError``.

Decompression per strip or tile: Deflate is zlib; PackBits chases its
run headers in a Python loop and expands them with ``np.repeat``; LZW
(TIFF's MSB-first codes, 9 to 12 bits, the width rising one code early)
is decoded without a per-code loop.  Between two Clear codes the code
widths follow from the codes' count alone, so each such stretch is read
with one vectorised bit extraction; and the string an entry code names
(the string of the code that defined the entry plus the first byte of
the code after it) is the stretch of output that starts where that code's
output starts, so every output byte is a literal or a copy of an earlier
byte, and pointer doubling resolves the copies.

``encode_tiff`` writes uncompressed strips (8- and 16-bit grey, 8-bit
RGB), in either byte order and with any number of rows per strip.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURES = (b"II*\x00", b"MM\x00*")
BIG_SIGNATURES = (b"II+\x00", b"MM\x00+")

# tag numbers (TIFF 6.0, section 8)
WIDTH, HEIGHT, BITS, COMPRESSION, PHOTOMETRIC, FILL_ORDER = 256, 257, 258, 259, 262, 266
STRIP_OFFSETS, SAMPLES, ROWS_PER_STRIP, STRIP_BYTES = 273, 277, 278, 279
PLANAR, PREDICTOR, TILE_WIDTH, TILE_LENGTH, TILE_OFFSETS, TILE_BYTES = 284, 317, 322, 323, 324, 325
EXTRA_SAMPLES, SAMPLE_FORMAT = 338, 339
TAG_NAMES = {
    COMPRESSION: "Compression", PHOTOMETRIC: "PhotometricInterpretation", FILL_ORDER: "FillOrder",
    BITS: "BitsPerSample", SAMPLES: "SamplesPerPixel", PLANAR: "PlanarConfiguration",
    PREDICTOR: "Predictor", TILE_WIDTH: "TileWidth", TILE_OFFSETS: "TileOffsets",
    SAMPLE_FORMAT: "SampleFormat", EXTRA_SAMPLES: "ExtraSamples",
}
NONE, LZW, DEFLATE, ADOBE_DEFLATE, PACKBITS = 1, 5, 8, 32946, 32773
# field type -> (struct code, size); 16-18 are BigTIFF's 8-byte integers
_TYPES = {1: ("B", 1), 2: ("c", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8), 6: ("b", 1),
          7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8), 11: ("f", 4), 12: ("d", 8),
          13: ("I", 4), 16: ("Q", 8), 17: ("q", 8), 18: ("Q", 8)}
_CLEAR, _EOI = 256, 257


def _ifd(buf: bytes, path: str) -> tuple[str, dict[int, tuple]]:
    """(byte order, {tag: values}) of the first image file directory."""
    big = buf[:4] in BIG_SIGNATURES
    if buf[:4] not in SIGNATURES and not big:
        if buf[:2] in (b"II", b"MM") and len(buf) >= 4:
            raise NotImplementedError(f"{path}: unknown TIFF version is not supported")
        raise ValueError(f"{path}: not a TIFF file")
    if len(buf) < (16 if big else 8):
        raise ValueError(f"{path}: truncated TIFF header")
    bo = "<" if buf[:2] == b"II" else ">"
    if big:
        offsize, _ = struct.unpack(bo + "HH", buf[4:8])
        if offsize != 8:
            raise ValueError(f"{path}: BigTIFF with {offsize}-byte offsets")
        (pos,) = struct.unpack(bo + "Q", buf[8:16])
    else:
        (pos,) = struct.unpack(bo + "I", buf[4:8])
    count, entry_size, inline, off = ("Q", 20, 8, "Q") if big else ("H", 12, 4, "I")
    head = struct.calcsize(count)
    if pos + head > len(buf):
        raise ValueError(f"{path}: truncated TIFF (no image file directory)")
    (n,) = struct.unpack(bo + count, buf[pos : pos + head])
    if pos + head + entry_size * n > len(buf):
        raise ValueError(f"{path}: truncated TIFF directory")
    tags = {}
    for i in range(n):
        entry = buf[pos + head + entry_size * i : pos + head + entry_size * (i + 1)]
        tag, kind = struct.unpack(bo + "HH", entry[:4])
        (cnt,) = struct.unpack(bo + count.replace("H", "I"), entry[4 : 4 + inline])
        if kind not in _TYPES:
            continue
        code, size = _TYPES[kind]
        nbytes = size * cnt
        if nbytes <= inline:
            data = entry[4 + inline : 4 + inline + nbytes]
        else:
            (at,) = struct.unpack(bo + off, entry[4 + inline :])
            if at + nbytes > len(buf):
                raise ValueError(f"{path}: truncated TIFF (tag {tag} data)")
            data = buf[at : at + nbytes]
        tags[tag] = struct.unpack(bo + code * cnt, data) if kind != 2 else (data,)
    return bo, tags


def _refuse(path: str, tag: int, value) -> None:
    raise NotImplementedError(f"{path}: TIFF {TAG_NAMES.get(tag, tag)} (tag {tag}) = {value} is not supported")


def _packbits(data: bytes, need: int, path: str) -> np.ndarray:
    """PackBits: a header n < 128 copies n + 1 bytes, n > 128 repeats the
    next byte 257 - n times, 128 is a no-op."""
    src = np.frombuffer(data, np.uint8)
    starts, counts = [], []
    pos, have, end = 0, 0, len(data)
    while have < need and pos < end:
        n = data[pos]
        if n < 128:
            starts.append(pos + 1)
            counts.append(-(n + 1))  # negative: a literal run
            pos, have = pos + 2 + n, have + n + 1
        elif n > 128:
            starts.append(pos + 1)
            counts.append(257 - n)
            pos, have = pos + 2, have + 257 - n
        else:
            pos += 1
    if have < need or pos > end:
        raise ValueError(f"{path}: corrupt or truncated PackBits data")
    starts, counts = np.array(starts), np.array(counts)
    lengths = np.abs(counts)
    within = np.arange(lengths.sum()) - np.repeat(np.cumsum(lengths) - lengths, lengths)
    literal = np.repeat(counts < 0, lengths)
    idx = np.repeat(starts, lengths) + np.where(literal, within, 0)
    return src[idx[:need]]


def _lzw_codes(data: bytes, path: str) -> list[np.ndarray]:
    """The codes of an LZW stream, split after each Clear code: one array
    per stretch that starts with a Clear (or the stream's start), up to an
    EOI or the end of the data."""
    bits = np.unpackbits(np.frombuffer(data, np.uint8))
    total = len(bits)
    # code i after a Clear is 9 bits up to i = 253, 10 to 765, 11 to 1789, then 12
    widths = np.full(4096, 12)
    widths[:254], widths[254:766], widths[766:1790] = 9, 10, 11
    offsets = np.concatenate([[0], np.cumsum(widths)])
    weight = [1 << np.arange(w - 1, -1, -1) for w in range(13)]
    stretches, pos = [], 0
    while pos + 9 <= total:
        n = int(np.searchsorted(offsets, total - pos, side="right")) - 1  # whole codes left
        n = min(n, 4096)
        starts = pos + offsets[:n]
        codes = np.zeros(n, np.int64)
        for w in (9, 10, 11, 12):
            sel = widths[:n] == w
            if sel.any():
                codes[sel] = bits[starts[sel, None] + np.arange(w)] @ weight[w]
        stop = np.flatnonzero((codes == _CLEAR) | (codes == _EOI))
        first = int(stop[0]) if len(stop) else n
        if first:
            stretches.append(codes[:first])
        if not len(stop) or codes[first] == _EOI:
            if not len(stop) and n == 4096:
                raise ValueError(f"{path}: corrupt LZW data (table overflow)")
            break
        pos = int(starts[first]) + int(widths[first])
    return stretches


def _lzw(data: bytes, need: int, path: str) -> np.ndarray:
    """TIFF LZW (module docstring)."""
    if data[:2] == b"\x00\x01":
        raise NotImplementedError(f"{path}: old-style (pre-TIFF 6) LZW is not supported")
    stretches = _lzw_codes(data, path)
    if not stretches:
        raise ValueError(f"{path}: empty LZW data")
    codes = np.concatenate(stretches)
    stretch = np.repeat(np.arange(len(stretches)), [len(s) for s in stretches])
    first = np.concatenate([[0], np.cumsum([len(s) for s in stretches])[:-1]])
    i = np.arange(len(codes)) - first[stretch]  # index within the stretch
    literal = codes < 256
    # an entry code 258 + j names code j's string plus the next code's first byte
    j = codes - 258
    if np.any(~literal & ((j < 0) | (j >= i))) or np.any(i[literal] < 0):
        raise ValueError(f"{path}: corrupt LZW data (a code names an entry not yet defined)")
    src = np.where(literal, -1, first[stretch] + j)  # the code, in the global numbering, whose string is copied
    # each code's string is one byte longer than the string of the code it names: its length is
    # 1 + its distance from a literal along those names (pointer doubling)
    dist, parent = (src >= 0).astype(np.int64), src.copy()
    while (parent >= 0).any():
        has = parent >= 0
        dist[has] += dist[parent[has]]
        parent[has] = parent[parent[has]]
    length = dist + 1
    start = np.concatenate([[0], np.cumsum(length)[:-1]])
    out_len = int(length.sum())
    if out_len < need:
        raise ValueError(f"{path}: LZW data holds {out_len} of {need} bytes")
    # every output byte: a literal, or a copy of the byte at its offset in the named code's output
    owner = np.repeat(np.arange(len(codes)), length)
    offset = np.arange(out_len) - start[owner]
    at = np.where(literal[owner], np.arange(out_len), start[np.maximum(src, 0)[owner]] + offset)
    while True:
        nxt = at[at]
        if np.array_equal(nxt, at):
            break
        at = nxt
    return codes[owner[at[:need]]].astype(np.uint8)


def _decompress(compression: int, data: bytes, need: int, path: str) -> np.ndarray:
    """One strip's or tile's bytes, decompressed, the first ``need``."""
    if compression == NONE:
        out = np.frombuffer(data, np.uint8)
    elif compression in (DEFLATE, ADOBE_DEFLATE):
        try:
            out = np.frombuffer(zlib.decompressobj().decompress(data, need), np.uint8)
        except zlib.error as e:
            raise ValueError(f"{path}: corrupt Deflate data ({e})") from None
    elif compression == PACKBITS:
        out = _packbits(data, need, path)
    else:
        out = _lzw(data, need, path)
    if len(out) < need:
        raise ValueError(f"{path}: TIFF strip or tile holds {len(out)} of {need} bytes")
    return out[:need]

def _float_unpredict(px: np.ndarray, spp: int) -> np.ndarray:
    """Undo the floating-point predictor (3) on one chunk's rows of 32-bit
    samples, (rows, row bytes) uint8: each row's bytes summed along it with
    a stride of ``spp``, then each sample's bytes gathered from the row's
    byte planes (most significant first) into native order, as libtiff's
    fpAcc does."""
    rows, row_bytes = px.shape
    acc = px.reshape(rows, row_bytes // spp, spp).cumsum(axis=1, dtype=np.uint8).reshape(rows, row_bytes)
    be = acc.reshape(rows, 4, row_bytes // 4).transpose(0, 2, 1)
    return np.ascontiguousarray(be).view(">f4").astype("=f4").view(np.uint8).reshape(rows, row_bytes)


def _unpremultiply(px: np.ndarray) -> np.ndarray:
    """PIL's "RGBa" unpacking: colour * 255 // alpha, clipped; zero alpha
    gives zero colour."""
    a = px[..., 3:].astype(np.int32)
    rgb = np.where(a == 0, 0, np.minimum(px[..., :3].astype(np.int32) * 255 // np.maximum(a, 1), 255))
    return np.concatenate([rgb, a], axis=-1).astype(np.uint8)


def _pil_mode(px: np.ndarray, photometric: int, fmt: int, bits: int, extra: tuple, path: str) -> np.ndarray:
    """(H, W, spp) samples (native order) -> PIL's array for the mode its
    OPEN_INFO table gives this file (module docstring)."""
    spp = px.shape[2]
    colour = {2: 3, 5: 4}.get(photometric, 1)  # the samples that are not extra
    if spp != colour + len(extra) and not (photometric == 2 and spp == 4 and extra == ()):
        _refuse(path, EXTRA_SAMPLES, f"{extra} with {spp} samples per pixel")
    if photometric == 2 and spp == 4 and extra == ():  # RGBA with ExtraSamples missing
        extra = (2,)
    if any(extra[1:]):
        _refuse(path, EXTRA_SAMPLES, extra)
    if photometric in (0, 1, 6) and spp == 1:
        v = px[..., 0]
        if photometric == 6 and not (bits == 8 and fmt == 1):
            _refuse(path, PHOTOMETRIC, f"6 with {bits}-bit samples")
        if bits == 1 and fmt == 1:
            return (v == 0) if photometric == 0 else v.astype(bool)
        if bits in (2, 4) and fmt == 1:
            v = v * np.uint8(255 // ((1 << bits) - 1))
            return 255 - v if photometric == 0 else v
        if bits == 8 and (fmt == 1 or photometric == 1):
            return 255 - v if photometric == 0 and fmt == 1 else v.view(np.uint8)
        if bits == 12 and fmt == 1 and photometric == 1:
            return v
        if bits == 16 and (fmt == 1 or (fmt == 2 and photometric == 1)):
            return v.astype(np.int32) if fmt == 2 else v
        if bits == 32 and (fmt == 3 or photometric == 1):
            return v.view(np.float32 if fmt == 3 else np.int32)
    elif photometric == 1 and spp == 2 and bits == 8 and fmt == 1 and extra == (2,):
        return px
    elif photometric == 3 and fmt == 1 and bits in (1, 2, 4, 8) and (spp == 1 or (bits == 8 and extra in ((0,), (2,)))):
        return px if extra == (2,) else px[..., 0]
    elif fmt == 1 and bits in (8, 16) and photometric in (2, 5):
        if bits == 16:
            if extra and extra[0] == 1 or spp > colour + 1:
                _refuse(path, EXTRA_SAMPLES, f"{extra} with 16-bit samples")
            px = (px >> 8).astype(np.uint8)
        if photometric == 5:
            return px[..., :4]
        if not extra or extra[0] == 0:
            return px[..., :3]
        return _unpremultiply(px[..., :4]) if extra[0] == 1 else px[..., :4]
    _refuse(path, BITS, f"{bits}-bit samples of format {fmt}, photometric {photometric}, {spp} per pixel")


def decode_tiff(buf: bytes, path: str = "<bytes>") -> np.ndarray:
    """TIFF bytes -> the array PIL gives for them (module docstring)."""
    bo, tags = _ifd(buf, path)
    get = lambda tag, default: tags.get(tag, (default,))
    compression, predictor = get(COMPRESSION, 1)[0], get(PREDICTOR, 1)[0]
    if compression not in (NONE, LZW, DEFLATE, ADOBE_DEFLATE, PACKBITS):
        _refuse(path, COMPRESSION, compression)
    if compression not in (LZW, DEFLATE, ADOBE_DEFLATE):
        predictor = 1  # PIL's raw reader and libtiff's PackBits codec do not apply it
    if predictor not in (1, 2, 3):
        _refuse(path, PREDICTOR, predictor)
    if get(FILL_ORDER, 1)[0] != 1:
        _refuse(path, FILL_ORDER, get(FILL_ORDER, 1)[0])
    if WIDTH not in tags or HEIGHT not in tags:
        raise ValueError(f"{path}: TIFF without ImageWidth or ImageLength")
    W, H = tags[WIDTH][0], tags[HEIGHT][0]
    spp = get(SAMPLES, 1)[0]
    bits, fmts = tags.get(BITS, (1,)), tags.get(SAMPLE_FORMAT, (1,))
    if len(set(bits)) > 1:
        _refuse(path, BITS, bits)
    if len(set(fmts)) > 1 or fmts[0] not in (1, 2, 3):
        _refuse(path, SAMPLE_FORMAT, fmts if len(set(fmts)) > 1 else fmts[0])
    bits, fmt = bits[0], fmts[0]
    if bits not in (1, 2, 4, 8, 12, 16, 32) or (fmt == 3 and bits != 32):
        _refuse(path, BITS, f"{bits} (format {fmt})")
    photometric = get(PHOTOMETRIC, None)[0]
    if photometric not in (0, 1, 2, 3, 5, 6):
        _refuse(path, PHOTOMETRIC, photometric)
    planar = get(PLANAR, 1)[0]
    if planar not in (1, 2):
        _refuse(path, PLANAR, planar)
    tiled = TILE_OFFSETS in tags
    if tiled:
        if TILE_WIDTH not in tags or TILE_LENGTH not in tags:
            raise ValueError(f"{path}: tiled TIFF without TileWidth or TileLength")
        cw, ch = tags[TILE_WIDTH][0], tags[TILE_LENGTH][0]
        offsets, counts = tags[TILE_OFFSETS], tags.get(TILE_BYTES)
    elif STRIP_OFFSETS in tags:
        cw, ch = W, min(get(ROWS_PER_STRIP, H)[0], H)
        offsets, counts = tags[STRIP_OFFSETS], tags.get(STRIP_BYTES)
    else:
        raise ValueError(f"{path}: TIFF without StripOffsets or TileOffsets")
    if cw <= 0 or ch <= 0:
        raise ValueError(f"{path}: TIFF strips or tiles of {cw} x {ch} pixels")
    planes, per_chunk = (spp, 1) if planar == 2 else (1, spp)
    across, down = -(-W // cw), -(-H // ch)
    n_chunks = planes * across * down
    if len(offsets) < n_chunks:
        raise ValueError(f"{path}: TIFF with {len(offsets)} of {n_chunks} strips or tiles")
    if (predictor == 2 and bits not in (8, 16, 32)) or (predictor == 3 and (bits != 32 or fmt != 3)):
        _refuse(path, PREDICTOR, f"{predictor} with {bits}-bit samples of format {fmt}")
    row_bytes = -(-cw * per_chunk * bits // 8)
    if bits in (8, 16, 32):
        dtype = np.dtype(bo + {1: "u", 2: "i", 3: "f"}[fmt] + str(bits // 8))
        native = dtype.newbyteorder("=")
    else:
        dtype = native = np.dtype(np.uint16 if bits == 12 else np.uint8)
    px = np.empty((H, W, spp), native)
    for i, off in enumerate(offsets[:n_chunks]):
        plane, k = divmod(i, across * down)
        y0, x0 = (k // across) * ch, (k % across) * cw
        rows = ch if tiled else min(ch, H - y0)
        need = rows * row_bytes
        size = need if compression == NONE else (counts[i] if counts is not None else len(buf) - off)
        if off + size > len(buf):
            raise ValueError(f"{path}: truncated TIFF (strip or tile {i})")
        raw = _decompress(compression, buf[off : off + size], need, path).reshape(rows, row_bytes)
        if predictor == 3:
            chunk = _float_unpredict(raw, per_chunk).view(native).reshape(rows, cw, per_chunk)
        elif bits in (8, 16, 32):
            chunk = raw.view(dtype).reshape(rows, cw, per_chunk).astype(native)
            if predictor == 2:  # horizontal differences of the samples, modulo their size
                u = chunk.view(f"=u{native.itemsize}")
                np.cumsum(u, axis=1, dtype=u.dtype, out=u)
        else:  # 1-, 2-, 4- or 12-bit samples, MSB first, each row padded to a byte
            b = np.unpackbits(raw, axis=1)[:, : cw * per_chunk * bits].reshape(rows, cw * per_chunk, bits)
            weights = (1 << np.arange(bits - 1, -1, -1)).astype(native)
            chunk = (b.astype(native) * weights).sum(-1, dtype=native).reshape(rows, cw, per_chunk)
        h, w = min(rows, H - y0), min(cw, W - x0)
        px[y0 : y0 + h, x0 : x0 + w, plane : plane + per_chunk] = chunk[:h, :w]
    if bo == ">" and ((bits == 16 and photometric == 0) or (bits == 32 and fmt == 1) or bits == 12):
        _refuse(path, BITS, f"{bits} (format {fmt}, photometric {photometric}) in big-endian order")
    if compression != NONE and bo == ">" and (bits == 32 or (bits == 16 and fmt == 2)):
        # libtiff hands PIL native samples, which PIL unpacks as big-endian
        # ("I;16BS", "I;32BS", "F;32BF"): it returns them byte-swapped
        px = px.byteswap()
    return _pil_mode(px, photometric, fmt, bits, tuple(tags.get(EXTRA_SAMPLES, ())), path)


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
