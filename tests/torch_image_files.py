"""Writers of the PNG and TIFF variants that PIL reads but does not write,
on numpy, zlib and struct alone (no PIL): Adam7-interlaced and sub-byte
PNGs with every scanline filter, and TIFFs in strips or tiles, chunky or
planar, classic or BigTIFF, uncompressed, LZW or Deflate, with or without
the horizontal or the floating-point predictor.

The port's decoders (picopose_tpu_torch/data/{png,tiff}.py) are held to
``np.asarray(PIL.Image.open(path))`` on these files in
tests/test_torch_formats.py, and ``chip_smoke.py`` (phase 16) rewrites a
BOP tree's frames with them on the card's host, which has no PIL.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


# ------------------------------------------------------------------ PNG
def _filter_rows(x: np.ndarray, bpp: int, ftype: np.ndarray) -> np.ndarray:
    """Filter (H, row bytes) uint8 rows with the per-row filter types."""
    x = x.astype(np.int16)
    a, b, c = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)  # left, above, above-left
    a[:, bpp:], b[1:], c[1:, bpp:] = x[:, :-bpp], x[:-1], x[:-1, :-bpp]
    out = np.empty_like(x)
    for k in range(5):
        r = ftype == k
        ar, br, cr = a[r], b[r], c[r]
        pa, pb, pc = np.abs(br - cr), np.abs(ar - cr), np.abs(ar + br - 2 * cr)
        pred = [0, ar, br, (ar + br) >> 1, np.where((pa <= pb) & (pa <= pc), ar, np.where(pb <= pc, br, cr))][k]
        out[r] = (x[r] - pred) & 255
    return out.astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def png_bytes(samples: np.ndarray, colour: int, depth: int, interlace: bool = False,
              palette: bytes | None = None, level: int = 6) -> bytes:
    """A PNG of (H, W, spp) unsigned samples (values < 2 ** depth) of
    ``colour`` type at ``depth`` bits, Adam7-interlaced if ``interlace``;
    row y of each (pass) image takes filter y % 5."""
    H, W, spp = samples.shape
    raw = []
    for y0, x0, dy, dx in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        h, w = sub.shape[:2]
        if depth == 16:
            rows = sub.astype(">u2").view(np.uint8).reshape(h, -1)
        elif depth == 8:
            rows = sub.astype(np.uint8).reshape(h, -1)
        else:
            bits = (sub.reshape(h, w * spp, 1) >> np.arange(depth - 1, -1, -1)) & 1
            rows = np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)
        ftype = (np.arange(h) % 5).astype(np.uint8)
        raw.append(np.concatenate([ftype[:, None], _filter_rows(rows, max(1, spp * depth // 8), ftype)], 1))
    data = b"".join(r.tobytes() for r in raw)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, colour, 0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", palette)
    return out + _chunk(b"IDAT", zlib.compress(data, level)) + _chunk(b"IEND", b"")


# ------------------------------------------------------------------ TIFF
def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW: a Clear code first, codes of 9 to 12 bits MSB first, the
    width rising one code early, a Clear when the table is full, EOI."""
    codes, widths = [256], [9]
    table = {bytes([i]): i for i in range(256)}
    nxt, width, w = 258, 9, b""
    for byte in data:
        wc = w + bytes([byte])
        if wc in table:
            w = wc
            continue
        codes.append(table[w])
        widths.append(width)
        table[wc] = nxt
        nxt += 1
        if nxt == 4094:  # table full: Clear, at the width the decoder reads it with
            codes.append(256)
            widths.append(12)
            table = {bytes([i]): i for i in range(256)}
            nxt, width = 258, 9
        elif nxt == 1 << width:  # the decoder, one entry behind, widens at 2 ** width - 1
            width += 1
        w = bytes([byte])
    if w:
        codes.append(table[w])
        widths.append(width)
        nxt += 1
        if nxt == 1 << width:
            width += 1
    codes.append(257)
    widths.append(width)
    c, wd = np.array(codes, np.int64), np.array(widths)
    bits = (c[:, None] >> (11 - np.arange(12))) & 1  # 12 bits per code, MSB first
    keep = np.arange(12)[None, :] >= 12 - wd[:, None]
    return np.packbits(bits[keep].astype(np.uint8)).tobytes()


def _horizontal_differences(chunk: np.ndarray) -> np.ndarray:
    """Predictor 2 on (rows, cols, spp) samples: each minus its left
    neighbour, modulo the sample size."""
    u = chunk.view(f"u{chunk.dtype.itemsize}").copy()
    u[:, 1:] -= chunk.view(u.dtype)[:, :-1]
    return u.view(chunk.dtype)


def _float_differences(chunk: np.ndarray) -> np.ndarray:
    """Predictor 3 on (rows, cols, spp) float32 samples: each row's bytes
    laid out plane by plane, most significant first, then differenced
    with a stride of spp; (rows, row bytes) uint8."""
    rows, cols, spp = chunk.shape
    be = np.ascontiguousarray(chunk, ">f4").view(np.uint8).reshape(rows, cols * spp, 4)
    planes = be.transpose(0, 2, 1).reshape(rows, -1)
    out = planes.copy()
    out[:, spp:] -= planes[:, :-spp]
    return out


def tiff_bytes(samples: np.ndarray, photometric: int, compression: int = 1, predictor: int = 1,
               tile: tuple[int, int] | None = None, planar: bool = False, big: bool = False,
               big_endian: bool = False, rows_per_strip: int | None = None, sample_format: int = 1,
               extra: tuple = (), depth: int | None = None, palette: bool = False) -> bytes:
    """A TIFF of (H, W, spp) samples (their dtype sets the bits, unless
    ``depth`` packs sub-byte values): strips of ``rows_per_strip`` rows or
    tiles of ``tile`` (width, length) pixels, planar or chunky, classic or
    BigTIFF, uncompressed (1), LZW (5) or Deflate (8), predictor 1-3."""
    H, W, spp = samples.shape
    bo = ">" if big_endian else "<"
    bits = depth or samples.dtype.itemsize * 8
    cw, ch = tile if tile else (W, min(rows_per_strip or H, H))
    planes, per = (spp, 1) if planar else (1, spp)
    chunks = []
    for p in range(planes):
        for y0 in range(0, H, ch):
            for x0 in range(0, W, cw):
                c = samples[y0 : y0 + ch, x0 : x0 + cw, p : p + per]
                if tile:  # tiles are whole, padded past the image with zeros
                    c = np.pad(c, ((0, ch - c.shape[0]), (0, cw - c.shape[1]), (0, 0)))
                if depth and depth < 8:
                    b = (c.reshape(c.shape[0], -1, 1) >> np.arange(depth - 1, -1, -1)) & 1
                    data = np.packbits(b.reshape(c.shape[0], -1).astype(np.uint8), axis=1).tobytes()
                elif predictor == 3:
                    data = _float_differences(c).tobytes()
                else:
                    c = _horizontal_differences(c) if predictor == 2 else c
                    data = np.ascontiguousarray(c, c.dtype.newbyteorder(bo)).tobytes()
                if compression == 5:
                    data = lzw_encode(data)
                elif compression in (8, 32946):
                    data = zlib.compress(data, 6)
                chunks.append(data)
    head = 16 if big else 8
    body, offsets = b"", []
    for data in chunks:
        offsets.append(head + len(body))
        body += data + b"\x00" * (len(data) & 1)
    off_kind = 16 if big else 4
    tags = [(256, 4, [W]), (257, 4, [H]), (258, 3, [bits] * spp), (259, 3, [compression]),
            (262, 3, [photometric]), (277, 3, [spp]), (284, 3, [2 if planar else 1])]
    if tile:
        tags += [(322, 4, [cw]), (323, 4, [ch]), (324, off_kind, offsets), (325, off_kind, [len(c) for c in chunks])]
    else:
        tags += [(273, off_kind, offsets), (278, 4, [ch]), (279, off_kind, [len(c) for c in chunks])]
    if predictor != 1:
        tags.append((317, 3, [predictor]))
    if extra:
        tags.append((338, 3, list(extra)))
    if sample_format != 1:
        tags.append((339, 3, [sample_format] * spp))
    if palette:
        tags.append((320, 3, [(i * 257) % 65536 for i in range(3 << bits)]))
    tags.sort()
    codes = {3: "H", 4: "I", 16: "Q"}
    inline, entry_head = (8, "HHQ") if big else (4, "HHI")
    n_fmt = "Q" if big else "H"
    ifd_at = head + len(body)
    entries, out_of_line = [], b""
    entry_size = 20 if big else 12
    extra_at = ifd_at + (8 if big else 2) + len(tags) * entry_size + inline
    for tag, kind, values in tags:
        payload = struct.pack(bo + codes[kind] * len(values), *values)
        if len(payload) <= inline:
            field = payload.ljust(inline, b"\x00")
        else:
            field = struct.pack(bo + ("Q" if big else "I"), extra_at + len(out_of_line))
            out_of_line += payload
        entries.append(struct.pack(bo + entry_head, tag, kind, len(values)) + field)
    if big:
        header = (b"MM\x00+" if big_endian else b"II+\x00") + struct.pack(bo + "HHQ", 8, 0, ifd_at)
    else:
        header = (b"MM\x00*" if big_endian else b"II*\x00") + struct.pack(bo + "I", ifd_at)
    ifd = struct.pack(bo + n_fmt, len(tags)) + b"".join(entries) + struct.pack(bo + ("Q" if big else "I"), 0)
    return header + body + ifd + out_of_line
