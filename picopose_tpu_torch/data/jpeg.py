"""JPEG decoding and encoding on numpy, and ``read_image``.

The port's counterpart of what picopose_tpu/data/bop.py::_load_im (:56-67)
gets from PIL for a ``.jpg``: the MegaPose shards' ``rgb.jpg`` frames and
BOP test frames stored as ``rgb/*.jpg``.  The arrays are those
``np.asarray(PIL.Image.open(path))`` gives with PIL's libjpeg-turbo:
(H, W, 3) uint8 RGB, (H, W) for greyscale, (H, W, 4) for CMYK.

Read: sequential Huffman JPEG (SOF0, and SOF1 at 8 bits) and progressive
Huffman JPEG (SOF2: DC and AC first and refinement scans, spectral
selection, successive approximation, EOB runs); 1, 3 or 4 components;
sampling factors 1 to 4 (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1, 4:1:0 and
the rest libjpeg-turbo upsamples by whole factors); interleaved or one
scan per component; restart intervals; APPn and COM segments skipped; an
Adobe APP14 transform flag honoured.  Four components are Adobe CMYK
(transform 0, or no Adobe segment) or YCCK (transform 2), returned as PIL
returns them: inverted, the Adobe convention.  Arithmetic-coded,
lossless and hierarchical files, 12-bit samples, fractional sampling
ratios, and progressive files that libjpeg-turbo would block-smooth
(some of the first ten coefficients left unsent or unrefined by the last
scan) raise ``NotImplementedError`` naming the file; a truncated or
corrupt stream raises ``ValueError`` naming it.

The arithmetic is libjpeg-turbo's at its defaults (jpeg-6b semantics):

  * the islow integer IDCT (jidctint.c: 13-bit constants, 2 extra bits
    between the passes, the result wrapped to 10 bits and clamped through
    the range-limit table);
  * "fancy" triangular upsampling (jdsample.c) where a component is
    downsampled by exactly 2: h2v1 (3a + b + 1) >> 2 and (3a + b + 2) >> 2;
    h1v2 the same vertically; h2v2 a vertical 3a + b pass, then
    (3s + t + 8) >> 4 and (3s + t + 7) >> 4, with the first and last
    column (4s + 8) >> 4 and (4s + 7) >> 4; rows above the first and below
    the last repeat them; a component 2 samples wide or less, and every
    other whole ratio (int_upsample), is replicated instead;
  * YCbCr -> RGB by jdcolor.c's 16-bit fixed-point tables, rounding with
    ONE_HALF, clamped; YCCK -> CMYK as ycck_cmyk_convert does (255 minus
    that RGB, K as it is), then PIL's inversion.

Entropy decoding is serial.  The 16-bit window at every bit position of
a scan is computed in numpy, and per Huffman table a 65536-entry list
gives each window's bit count (code and value bits) and, for AC tables,
the step it adds to the coefficient index; the Python loop then only
chases symbol positions.  A progressive refinement scan's loop also
needs each block's coefficients that were non-zero before the scan
(their correction bits sit between the symbols): per block, the zero
positions of the band and the non-zero count behind each position are
laid out in numpy before the loop, which records where each run of
correction bits and each new coefficient's sign bit starts.  Coefficient
values, the corrections, dequantisation, the IDCT, upsampling and colour
conversion run vectorised over all blocks at once.

Write: ``encode_jpeg`` / ``write_jpeg``, the counterpart of what PIL's
libjpeg-turbo writes at its defaults (``PIL.Image.save(..., quality=q)``,
``imageio.imwrite(..., quality=q)``, which tools/synthetic_world.py uses
for its MegaPose frames): JFIF, YCbCr 4:2:0, baseline Huffman, byte for
byte the same file.  Its arithmetic is libjpeg's: jccolor.c's 16-bit
fixed-point RGB -> YCbCr, jcsample.c's h2v2 downsampling with its
alternating 1, 2 bias and edge replication, jfdctint.c's islow FDCT,
jcdctmgr.c's reciprocal quantiser (16-bit DCT elements), the Annex K
tables scaled by jcparam.c's quality rule with force_baseline, and the
dummy blocks jccoefct.c writes past the image's edge.
"""

from __future__ import annotations

import re
import struct

import numpy as np

from picopose_tpu_torch.data.png import SIGNATURE as PNG_SIGNATURE
from picopose_tpu_torch.data.png import decode_png
from picopose_tpu_torch.data.tiff import decode_tiff

SIGNATURE = b"\xff\xd8\xff"
# zigzag index -> natural (row-major) index (jutils.c jpeg_natural_order)
NATURAL_ORDER = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])
_SOF_NAMES = {0xC3: "lossless", 0xC5: "hierarchical", 0xC6: "hierarchical",
              0xC7: "hierarchical", 0xC9: "arithmetic", 0xCA: "arithmetic", 0xCB: "arithmetic",
              0xCD: "arithmetic", 0xCE: "arithmetic", 0xCF: "arithmetic"}
_END_OF_SCAN = re.compile(rb"\xff[^\x00]")
_EOB = 64  # AC step of an end-of-block symbol: ends the block whatever k is
_SHIFT = 7  # AC step entries pack bits << 7 | step
_FAR = 1 << 40  # the bits an invalid code "takes"
_MAX_BLOCKS_IN_MCU = 10  # libjpeg's D_MAX_BLOCKS_IN_MCU
_SMOOTHED = 10  # libjpeg-turbo block-smooths unless zigzag 1..9 are exact (SAVED_COEFS)


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.w = self.hgt = 0  # downsampled size, set with the frame
        self.coefs: np.ndarray | None = None  # (rows, cols, 64) zigzag, set with the frame
        self.qtable: np.ndarray | None = None  # latched at the component's first scan
        self.coef_bits = np.full(64, -1)  # progressive: each coefficient's Al so far, -1 unsent


def _huffman_table(counts: bytes, symbols: bytes, path: str) -> tuple[np.ndarray, np.ndarray]:
    """(code length, symbol) for every 16-bit window; length 0 = no code."""
    lengths = np.zeros(1 << 16, np.int64)
    values = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for n in range(1, 17):
        for _ in range(counts[n - 1]):
            if code >= 1 << n:
                raise ValueError(f"{path}: corrupt JPEG (bad Huffman table)")
            lo, hi = code << (16 - n), (code + 1) << (16 - n)
            lengths[lo:hi], values[lo:hi] = n, symbols[k]
            code, k = code + 1, k + 1
        code <<= 1
    return lengths, values


def _extend(raw: np.ndarray, size: np.ndarray) -> np.ndarray:
    """F.2.2.1 EXTEND: ``size`` raw bits -> a signed value."""
    half = np.where(size > 0, 1 << np.maximum(size - 1, 0), 0)
    return np.where(raw < half, raw - (1 << size) + 1, raw)


def _idct_1d(x, descale):
    """One jidctint.c 1-D pass over x[0..7] (arrays), each output descaled
    by ``descale`` bits with rounding."""
    z1 = (x[2] + x[6]) * 4433
    tmp2 = z1 + x[6] * -15137
    tmp3 = z1 + x[2] * 6270
    tmp0 = (x[0] + x[4]) << 13
    tmp1 = (x[0] - x[4]) << 13
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * 9633
    o0, o1, o2, o3 = o0 * 2446, o1 * 16819, o2 * 25172, o3 * 12299
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    o0, o1, o2, o3 = o0 + z1 + z3, o1 + z2 + z4, o2 + z2 + z3, o3 + z1 + z4
    r = 1 << (descale - 1)
    return [(t10 + o3 + r) >> descale, (t11 + o2 + r) >> descale, (t12 + o1 + r) >> descale,
            (t13 + o0 + r) >> descale, (t13 - o0 + r) >> descale, (t12 - o1 + r) >> descale,
            (t11 - o2 + r) >> descale, (t10 - o3 + r) >> descale]


def _idct_islow(coef: np.ndarray) -> np.ndarray:
    """(n, 8, 8) dequantised int64 coefficients -> (n, 8, 8) uint8 samples."""
    cols = _idct_1d([coef[:, k, :] for k in range(8)], 13 - 2)  # pass 1: down each column
    ws = np.stack(cols, axis=1)
    rows = _idct_1d([ws[:, :, k] for k in range(8)], 13 + 2 + 3)  # pass 2: along each row
    v = np.stack(rows, axis=2) & 1023
    # the range-limit table: 10-bit two's complement, clamped to [-128, 127], + 128
    v = np.where(v >= 512, v - 1024, v)
    return (np.clip(v, -128, 127) + 128).astype(np.uint8)


def _upsample(plane: np.ndarray, fy: int, fx: int) -> np.ndarray:
    """jdsample.c's upsampling of a (h, w) component plane by (fy, fx)."""
    x = plane.astype(np.int32)
    h, w = x.shape
    if fy == 2 and fx == 2 and w > 2:  # h2v2_fancy_upsample
        above = np.concatenate([x[:1], x[:-1]])
        below = np.concatenate([x[1:], x[-1:]])
        out = np.empty((2 * h, 2 * w), np.int32)
        for r, far in ((0, above), (1, below)):
            s = 3 * x + far  # column sums
            last = np.concatenate([s[:, :1], s[:, :-1]], axis=1)
            nxt = np.concatenate([s[:, 1:], s[:, -1:]], axis=1)
            even, odd = (3 * s + last + 8) >> 4, (3 * s + nxt + 7) >> 4
            even[:, 0], odd[:, -1] = (4 * s[:, 0] + 8) >> 4, (4 * s[:, -1] + 7) >> 4
            out[r::2, 0::2], out[r::2, 1::2] = even, odd
        return out.astype(np.uint8)
    if fy == 1 and fx == 2 and w > 2:  # h2v1_fancy_upsample
        last = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
        nxt = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
        out = np.empty((h, 2 * w), np.int32)
        out[:, 0::2], out[:, 1::2] = (3 * x + last + 1) >> 2, (3 * x + nxt + 2) >> 2
        out[:, 0], out[:, -1] = x[:, 0], x[:, -1]
        return out.astype(np.uint8)
    if fy == 2 and fx == 1:  # h1v2_fancy_upsample
        above = np.concatenate([x[:1], x[:-1]])
        below = np.concatenate([x[1:], x[-1:]])
        out = np.empty((2 * h, w), np.int32)
        out[0::2], out[1::2] = (3 * x + above + 1) >> 2, (3 * x + below + 2) >> 2
        return out.astype(np.uint8)
    return np.repeat(np.repeat(plane, fy, axis=0), fx, axis=1)  # fullsize or replicated


def _ycc_tables():
    x = np.arange(256, dtype=np.int64) - 128
    one_half = 1 << 15
    cr_r = (91881 * x + one_half) >> 16
    cb_b = (116130 * x + one_half) >> 16
    cr_g = -46802 * x
    cb_g = -22554 * x + one_half
    return cr_r, cb_b, cr_g, cb_g


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    cr_r, cb_b, cr_g, cb_g = _ycc_tables()
    y = y.astype(np.int64)
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


class _Decoder:
    def __init__(self, buf: bytes, path: str):
        self.buf, self.path = buf, path
        self.qt: dict[int, np.ndarray] = {}
        self.huff: dict[tuple[int, int], tuple[np.ndarray, np.ndarray]] = {}
        self.steps: dict[tuple[int, int], list[int]] = {}
        self.restart = 0
        self.jfif = False
        self.adobe: int | None = None
        self.comps: list[_Component] = []
        self.height = self.width = 0
        self.progressive = False
        self.prog_ac: dict[int, tuple[list[int], list[int], list[int]]] = {}

    def fail(self, what: str):
        raise ValueError(f"{self.path}: corrupt JPEG ({what})")

    def decode(self) -> np.ndarray:
        buf, pos = self.buf, 2
        if buf[:3] != SIGNATURE:
            raise ValueError(f"{self.path}: not a JPEG file")
        while True:
            if pos >= len(buf):
                raise ValueError(f"{self.path}: truncated JPEG (no EOI marker)")
            if buf[pos] != 0xFF:
                self.fail(f"expected a marker at byte {pos}")
            while pos < len(buf) and buf[pos] == 0xFF:  # fill bytes
                pos += 1
            if pos >= len(buf):
                raise ValueError(f"{self.path}: truncated JPEG (no EOI marker)")
            marker = buf[pos]
            pos += 1
            if marker == 0xD9:  # EOI
                break
            if 0xD0 <= marker <= 0xD7 or marker == 0x01:  # stray RSTn, TEM: no payload
                continue
            if pos + 2 > len(buf):
                raise ValueError(f"{self.path}: truncated JPEG (marker segment)")
            (length,) = struct.unpack(">H", buf[pos : pos + 2])
            if length < 2 or pos + length > len(buf):
                raise ValueError(f"{self.path}: truncated JPEG (marker segment)")
            seg = buf[pos + 2 : pos + length]
            pos += length
            if marker == 0xDA:
                pos = self.scan(seg, pos)
            else:
                self.segment(marker, seg)
        if not self.comps or any(c.qtable is None for c in self.comps):
            raise ValueError(f"{self.path}: truncated JPEG (a component has no scan)")
        if self.progressive and any(c.coef_bits[0] >= 0 and np.any(c.coef_bits[1:_SMOOTHED] != 0)
                                    for c in self.comps):
            raise NotImplementedError(
                f"{self.path}: progressive JPEG whose scans leave some of the first {_SMOOTHED} coefficients "
                "unsent or unrefined is not supported (libjpeg-turbo block-smooths it)")
        return self.output()

    def segment(self, marker: int, seg: bytes) -> None:
        if marker in (0xC0, 0xC1, 0xC2):
            self.frame(seg, progressive=marker == 0xC2)
        elif marker in _SOF_NAMES:
            raise NotImplementedError(
                f"{self.path}: {_SOF_NAMES[marker]} JPEG is not supported (baseline and progressive Huffman only)")
        elif marker == 0xC4:
            self.define_huffman(seg)
        elif marker == 0xDB:
            self.define_quant(seg)
        elif marker == 0xDD:
            if len(seg) < 2:
                self.fail("DRI")
            self.restart = struct.unpack(">H", seg[:2])[0]
        elif marker == 0xE0 and seg[:5] == b"JFIF\x00":
            self.jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            self.adobe = seg[11]
        elif marker == 0xCC:
            raise NotImplementedError(f"{self.path}: arithmetic-coded JPEG is not supported (Huffman only)")
        elif marker == 0xDC:
            raise NotImplementedError(f"{self.path}: JPEG with a DNL marker is not supported")
        # other APPn, COM and unknown segments are skipped

    def frame(self, seg: bytes, progressive: bool = False) -> None:
        if len(seg) < 6:
            self.fail("SOF")
        precision, self.height, self.width, n = struct.unpack(">BHHB", seg[:6])
        self.progressive = progressive
        if precision != 8:
            raise NotImplementedError(f"{self.path}: {precision}-bit JPEG is not supported (8-bit only)")
        if n not in (1, 3, 4):
            raise NotImplementedError(f"{self.path}: JPEG with {n} components is not supported (1, 3 or 4 only)")
        if self.height == 0:
            raise NotImplementedError(f"{self.path}: JPEG with a DNL marker is not supported")
        if self.width == 0 or len(seg) < 6 + 3 * n:
            self.fail("SOF")
        for i in range(n):
            cid, hv, tq = seg[6 + 3 * i : 9 + 3 * i]
            h, v = hv >> 4, hv & 15
            if not (1 <= h <= 4 and 1 <= v <= 4):
                self.fail(f"sampling factors {h}x{v}")
            self.comps.append(_Component(cid, h, v, tq))
        if n == 1:  # a lone component's factors are ignored (its plane is the image)
            self.comps[0].h = self.comps[0].v = 1
        self.hmax = max(c.h for c in self.comps)
        self.vmax = max(c.v for c in self.comps)
        if any(self.hmax % c.h or self.vmax % c.v for c in self.comps):
            factors = ", ".join(f"{c.h}x{c.v}" for c in self.comps)
            raise NotImplementedError(f"{self.path}: JPEG sampling factors {factors} have a fractional ratio")
        self.mcux = -(-self.width // (8 * self.hmax))
        self.mcuy = -(-self.height // (8 * self.vmax))
        for c in self.comps:
            c.w = -(-self.width * c.h // self.hmax)
            c.hgt = -(-self.height * c.v // self.vmax)
            # zigzag coefficients, libjpeg's 16-bit JCOEF, zero until a scan
            # sets them (a progressive scan adds to them)
            c.coefs = np.zeros((self.mcuy * c.v, self.mcux * c.h, 64), np.int16)

    def define_huffman(self, seg: bytes) -> None:
        pos = 0
        while pos < len(seg):
            if pos + 17 > len(seg):
                self.fail("DHT")
            tc, th = seg[pos] >> 4, seg[pos] & 15
            counts = seg[pos + 1 : pos + 17]
            n = sum(counts)
            if tc > 1 or th > 3 or pos + 17 + n > len(seg):
                self.fail("DHT")
            L, S = self.huff[tc, th] = _huffman_table(counts, seg[pos + 17 : pos + 17 + n], self.path)
            if tc:
                self.prog_ac.pop(th, None)  # progressive files redefine tables between scans
            # per window, the bits its symbol takes (code and value) and, for
            # AC, the step it adds to the coefficient index; a window that
            # starts no code jumps past any scan (IndexError when decoding)
            if tc == 0:
                self.steps[tc, th] = np.where((L > 0) & (S <= 11), L + S, _FAR).tolist()
            else:
                size, run = S & 15, S >> 4
                step = np.where((size == 0) & (run != 15), _EOB, run + 1)
                self.steps[tc, th] = np.where((L > 0) & (size <= 10), ((L + size) << _SHIFT) | step,
                                              (_FAR << _SHIFT) | _EOB).tolist()
            pos += 17 + n

    def define_quant(self, seg: bytes) -> None:
        pos = 0
        while pos < len(seg):
            pq, tq = seg[pos] >> 4, seg[pos] & 15
            size = 128 if pq else 64
            if tq > 3 or pos + 1 + size > len(seg):
                self.fail("DQT")
            vals = np.frombuffer(seg[pos + 1 : pos + 1 + size], ">u2" if pq else np.uint8)
            table = np.zeros(64, np.int64)
            table[NATURAL_ORDER] = vals
            self.qt[tq] = table
            pos += 1 + size

    def scan(self, seg: bytes, pos: int) -> int:
        """Decode one scan's entropy-coded data from ``pos``; returns the
        position of the marker that ends it."""
        if not self.comps:
            self.fail("SOS before SOF")
        ns = seg[0] if seg else 0
        if ns < 1 or len(seg) < 1 + 2 * ns + 3:
            self.fail("SOS")
        Ss, Se, Ah, Al = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns] >> 4, seg[3 + 2 * ns] & 15
        # the tables the scan reads: both in a sequential scan; a progressive
        # DC first scan the DC table, an AC scan the AC table, a DC
        # refinement none
        need_dc = not self.progressive or (Ss == 0 and Ah == 0)
        need_ac = not self.progressive or Ss > 0
        by_id = {c.cid: c for c in self.comps}
        members = []
        for i in range(ns):
            cid, t = seg[1 + 2 * i : 3 + 2 * i]
            if (cid not in by_id or (need_dc and (0, t >> 4) not in self.huff)
                    or (need_ac and (1, t & 15) not in self.huff)):
                self.fail("SOS names an unknown component or table")
            members.append((by_id[cid], t >> 4, t & 15))
        if len(members) > 1 and sum(c.h * c.v for c, _, _ in members) > _MAX_BLOCKS_IN_MCU:
            self.fail("more than 10 blocks in an MCU")
        for c, _, _ in members:  # jdinput.c latch_quant_tables
            if c.qtable is None:
                if c.tq not in self.qt:
                    self.fail("missing quantisation table")
                c.qtable = self.qt[c.tq].copy()
        # the entropy-coded data, split at restart markers
        segments, start = [], pos
        while True:
            m = _END_OF_SCAN.search(self.buf, pos)
            if m is None:
                raise ValueError(f"{self.path}: truncated JPEG (scan data runs to the end of the file)")
            pos = m.start()
            if 0xD0 <= self.buf[pos + 1] <= 0xD7:
                segments.append(self.buf[start:pos].replace(b"\xff\x00", b"\xff"))
                pos = start = pos + 2
                continue
            segments.append(self.buf[start:pos].replace(b"\xff\x00", b"\xff"))
            break
        if not self.progressive:
            self.entropy_decode(members, segments)
            return pos
        # jdphuff.c start_pass_phuff_decoder's checks
        if Ss == 0:
            bad = Se != 0
        else:
            bad = Se < Ss or Se > 63 or len(members) != 1
        if bad or (Ah != 0 and Al != Ah - 1) or Al > 13:
            self.fail(f"progressive scan Ss={Ss} Se={Se} Ah={Ah} Al={Al}")
        if Ss == 0:
            (self.dc_refine if Ah else self.dc_first)(members, segments, Al)
        else:
            c, _, ta = members[0]
            (self.ac_refine if Ah else self.ac_first)(c, ta, segments, Ss, Se, Al)
        for c, _, _ in members:
            c.coef_bits[Ss : Se + 1] = Al
        return pos

    def _segments(self, segments, n_mcu: int):
        """(MCUs per restart interval, intervals, the 16-bit window at every
        bit position of the intervals' data joined (zero bits past the
        end), each interval's first bit and its end)."""
        ri = self.restart or n_mcu
        n_seg = -(-n_mcu // ri)
        if len(segments) < n_seg:
            raise ValueError(f"{self.path}: truncated JPEG (restart intervals missing)")
        seg_bits = np.cumsum([0] + [8 * len(s) for s in segments[:n_seg]])
        b = np.frombuffer(b"".join(segments[:n_seg]) + bytes(8), np.uint8).astype(np.int32)
        w24 = (b[:-2] << 16) | (b[1:-1] << 8) | b[2:]
        win = ((w24[:, None] >> np.arange(8, 0, -1, dtype=np.int32)) & 0xFFFF).astype(np.uint16).ravel()
        return ri, n_seg, win, seg_bits[:-1].tolist(), seg_bits[1:].tolist()

    def _truncated(self):
        raise ValueError(f"{self.path}: truncated or corrupt JPEG (scan data ends inside an MCU)")

    def entropy_decode(self, members, segments) -> None:
        n_mcu, nper, comp, flat = self._scan_blocks(members)
        ri, n_seg, win, seg_start, seg_end = self._segments(segments, n_mcu)
        plan = [(self.steps[0, members[i][1]], self.steps[1, members[i][2]]) for i in comp[:nper]]
        # the serial part: chase symbol positions
        dcpos, acpos, ends = [], [], []
        dap, aap, eap = dcpos.append, acpos.append, ends.append
        w = memoryview(win)
        try:
            for s in range(n_seg):
                q = seg_start[s]
                for _ in range(min(ri, n_mcu - s * ri)):
                    for dct, act in plan:
                        dap(q)
                        q += dct[w[q]]
                        k = 1
                        while k < 64:
                            aap(q)
                            v = act[w[q]]
                            k += v & 127
                            q += v >> _SHIFT
                        eap(len(acpos))
                if q > seg_end[s]:
                    raise IndexError
        except IndexError:
            self._truncated()
        self.coefficients(members, comp, flat, ri * nper, win, dcpos, np.array(acpos), np.array(ends))

    def coefficients(self, members, comp_of_block, flat, per_interval, win, dcpos, acpos, ends) -> None:
        """Values at the recorded symbol positions -> each component's
        zigzag coefficient blocks (``_scan_blocks``' block order)."""
        n_blocks = len(dcpos)
        counts = np.diff(np.concatenate([[0], ends]))
        block_of_sym = np.repeat(np.arange(n_blocks), counts)
        zz = np.zeros((n_blocks, 64), np.int64)
        # AC symbols
        lengths = np.zeros(len(acpos), np.int64)
        syms = np.zeros(len(acpos), np.int64)
        for i, (_, _, ta) in enumerate(members):
            sel = comp_of_block[block_of_sym] == i
            L, S = self.huff[1, ta]
            w = win[acpos[sel]]
            lengths[sel], syms[sel] = L[w], S[w]
        size, run = syms & 15, syms >> 4
        step = np.where((size == 0) & (run != 15), _EOB, run + 1)
        raw = win[acpos + lengths] >> (16 - size)
        val = _extend(raw, size)
        first = np.concatenate([[0], ends[:-1]])
        csum = np.cumsum(step)
        # a symbol's zigzag index: 1 + the steps before it in its block + its run
        k = csum - np.repeat(csum[first] - step[first], counts)
        hit = (step < _EOB) & (size > 0)
        if np.any(k[hit] > 63):
            self.fail("AC coefficients past index 63")
        zz[block_of_sym[hit], k[hit]] = val[hit]
        zz[:, 0] = self.dc_values(members, comp_of_block, np.array(dcpos), win, per_interval)
        for i, (c, _, _) in enumerate(members):
            sel = comp_of_block == i
            c.coefs.reshape(-1, 64)[flat[sel]] = zz[sel].astype(np.int16)

    def dc_values(self, members, comp_of_block, dcpos, win, per_interval: int) -> np.ndarray:
        """Each block's DC value: its coded difference, accumulated per
        component within each restart interval (``per_interval`` blocks)."""
        n_blocks = len(dcpos)
        diffs = np.zeros(n_blocks, np.int64)
        for i, (_, td, _) in enumerate(members):
            sel = comp_of_block == i
            L, S = self.huff[0, td]
            w = win[dcpos[sel]]
            ln, sz = L[w], S[w]
            diffs[sel] = _extend(win[dcpos[sel] + ln] >> (16 - sz), sz)
        interval = np.arange(n_blocks) // per_interval
        dc = np.zeros(n_blocks, np.int64)
        for i in range(len(members)):
            sel = comp_of_block == i
            d, grp = diffs[sel], interval[sel]
            cs = np.cumsum(d)
            starts = np.flatnonzero(np.diff(np.concatenate([[-1], grp])))
            base = np.repeat(cs[starts] - d[starts], np.diff(np.concatenate([starts, [len(d)]])))
            dc[sel] = cs - base
        return dc

    def _scan_blocks(self, members):
        """A scan's blocks in coding order: (MCUs, blocks per MCU, each
        block's member index, each block's row in its component's
        coefficients reshaped to (-1, 64)).  A one-component scan codes
        the component's own block grid, an interleaved one each member's
        v x h blocks of every MCU, row by row."""
        if len(members) == 1:  # non-interleaved: the component's own block grid
            c = members[0][0]
            rows, cols = -(-c.hgt // 8), -(-c.w // 8)
            flat = (np.arange(rows)[:, None] * c.coefs.shape[1] + np.arange(cols)).ravel()
            return rows * cols, 1, np.zeros(rows * cols, np.int64), flat
        my, mx = np.meshgrid(np.arange(self.mcuy), np.arange(self.mcux), indexing="ij")
        comp, flat = [], []
        for i, (c, _, _) in enumerate(members):
            for dy in range(c.v):
                for dx in range(c.h):
                    comp.append(np.full(my.size, i))
                    flat.append(((my * c.v + dy) * c.coefs.shape[1] + mx * c.h + dx).ravel())
        # (block of the MCU, MCU) -> MCU-major
        comp, flat = np.stack(comp, 1).ravel(), np.stack(flat, 1).ravel()
        return my.size, len(flat) // my.size, comp, flat

    # ------------------------------------------------------ progressive scans
    def dc_first(self, members, segments, Al: int) -> None:
        """DC first scan: each block's difference, as a sequential scan codes
        it, accumulated and shifted up by ``Al``."""
        n_mcu, nper, comp, flat = self._scan_blocks(members)
        ri, n_seg, win, seg_start, seg_end = self._segments(segments, n_mcu)
        plan = [self.steps[0, members[i][1]] for i in comp[:nper]]
        dcpos = []
        dap = dcpos.append
        w = memoryview(win)
        try:
            for s in range(n_seg):
                q = seg_start[s]
                for _ in range(min(ri, n_mcu - s * ri)):
                    for dct in plan:
                        dap(q)
                        q += dct[w[q]]
                if q > seg_end[s]:
                    raise IndexError
        except IndexError:
            self._truncated()
        dc = self.dc_values(members, comp, np.array(dcpos), win, ri * nper) << Al
        for i, (c, _, _) in enumerate(members):
            c.coefs.reshape(-1, 64)[flat[comp == i], 0] = dc[comp == i]

    def dc_refine(self, members, segments, Al: int) -> None:
        """DC refinement: one raw bit per block, its bit ``Al``."""
        n_mcu, nper, comp, flat = self._scan_blocks(members)
        ri, n_seg, win, seg_start, seg_end = self._segments(segments, n_mcu)
        blk = np.arange(len(flat))
        seg = blk // (ri * nper)
        pos = np.array(seg_start)[seg] + blk - seg * ri * nper
        if np.any(pos >= np.array(seg_end)[seg]):
            self._truncated()
        bit = (win[pos].astype(np.int32) >> 15) << Al
        for i, (c, _, _) in enumerate(members):
            c.coefs.reshape(-1, 64)[flat[comp == i], 0] |= bit[comp == i]

    def _progressive_ac(self, ta: int):
        """AC table ``ta`` for the progressive loops: per window (first
        scans) the bits taken (code and value or EOB-run bits) << 7 | the
        coefficient step (run + 1, 16 for ZRL, 64 for an EOB run);
        (refinement scans) code length << 8 | symbol; and the symbols."""
        if ta not in self.prog_ac:
            L, S = self.huff[1, ta]
            size, run = S & 15, S >> 4
            eob = (size == 0) & (run != 15)
            bits = L + np.where(eob, run, size)
            step = np.where(eob, 64, np.where(size > 0, run + 1, 16))
            first = np.where(L > 0, (bits << 7) | step, (_FAR << 7) | 64)
            refine = np.where(L > 0, (L << 8) | S, _FAR << 8)
            self.prog_ac[ta] = (first.tolist(), refine.tolist(), S.tolist())
        return self.prog_ac[ta]

    def ac_first(self, c: _Component, ta: int, segments, Ss: int, Se: int, Al: int) -> None:
        """AC first scan of band Ss..Se: run/size symbols as in a sequential
        scan, values shifted up by ``Al``, and EOB runs that end this block
        and the next (1 << r) + (r bits) - 1."""
        n, _, _, flat = self._scan_blocks([(c, 0, ta)])
        ri, n_seg, win, seg_start, seg_end = self._segments(segments, n)
        tab, _, sym = self._progressive_ac(ta)
        pos, blk = [], []
        pap, bap = pos.append, blk.append
        w = memoryview(win)
        try:
            for s in range(n_seg):
                q, eobrun = seg_start[s], 0
                for b in range(s * ri, min(n, (s + 1) * ri)):
                    if eobrun:
                        eobrun -= 1
                        continue
                    k = Ss
                    while k <= Se:
                        v = tab[w[q]]
                        if v & 127 == 64:
                            r = sym[w[q]] >> 4
                            q += v >> 7
                            if r:
                                eobrun = (1 << r) - 1 + (w[q - r] >> (16 - r))
                            break
                        pap(q)
                        bap(b)
                        k += v & 127
                        q += v >> 7
                if q > seg_end[s]:
                    raise IndexError
        except IndexError:
            self._truncated()
        if not pos:
            return
        pos, blk = np.array(pos), np.array(blk)
        L, S = self.huff[1, ta]
        wv = win[pos]
        ln, rs = L[wv], S[wv]
        size, run = rs & 15, rs >> 4
        step = np.where(size > 0, run + 1, 16)
        # a symbol's zigzag index: Ss + the steps before it in its block + its run
        first = np.flatnonzero(np.r_[True, blk[1:] != blk[:-1]])
        counts = np.diff(np.r_[first, len(blk)])
        before = np.cumsum(step) - step
        k = Ss + before - np.repeat(before[first], counts) + run
        hit = size > 0
        if np.any(k[hit] > Se):
            self.fail(f"AC coefficients past index {Se}")
        val = _extend(win[pos + ln] >> (16 - size), size) << Al
        c.coefs.reshape(-1, 64)[flat[blk[hit]], k[hit]] = val[hit]

    def ac_refine(self, c: _Component, ta: int, segments, Ss: int, Se: int, Al: int) -> None:
        """AC refinement of band Ss..Se (jdphuff.c decode_mcu_AC_refine):
        each symbol makes one zero coefficient +-(1 << Al) (its sign bit
        follows the code) after skipping ``run`` zeros, and every
        coefficient that was non-zero before the scan and is passed over,
        by a symbol, a ZRL or an EOB run, takes one correction bit, which
        adds 1 << Al away from zero where that bit is still clear."""
        n, _, _, flat = self._scan_blocks([(c, 0, ta)])
        ri, n_seg, win, seg_start, seg_end = self._segments(segments, n)
        _, tab, _ = self._progressive_ac(ta)
        nb = Se - Ss + 1
        band = c.coefs.reshape(-1, 64)[flat, Ss : Se + 1]
        nz = band != 0
        zeros_before = np.zeros((n, nb + 1), np.int64)  # zeros of the band before index k
        np.cumsum(~nz, axis=1, out=zeros_before[:, 1:])
        nz_from = nz.sum(1)[:, None] - (np.arange(nb + 1) - zeros_before)  # non-zeros at k and after
        rr, kk = np.nonzero(~nz)
        zero_at = np.full((n, nb + 16), nb)  # the band's zeros in order, then past-the-end
        zero_at[rr, zeros_before[rr, kk]] = kk
        zb, nf, za = zeros_before.ravel().tolist(), nz_from.ravel().tolist(), zero_at.ravel().tolist()
        runs, new = [], []  # (block, band index, count, first bit) of correction bits; (block, index, sign bit)
        rap, nap = runs.append, new.append
        w = memoryview(win)
        try:
            for s in range(n_seg):
                q, eobrun = seg_start[s], 0
                for b in range(s * ri, min(n, (s + 1) * ri)):
                    o = b * (nb + 1)
                    if eobrun:
                        cnt = nf[o]
                        if cnt:
                            rap((b, 0, cnt, q))
                            q += cnt
                        eobrun -= 1
                        continue
                    oz, k = b * (nb + 16), 0
                    while k < nb:
                        e = tab[w[q]]
                        q += e >> 8
                        r = (e >> 4) & 15
                        if e & 15:
                            sign = q
                            q += 1
                        elif r != 15:  # an EOB run from this block on
                            eobrun = 1 << r
                            if r:
                                eobrun += w[q] >> (16 - r)
                                q += r
                            cnt = nf[o + k]
                            if cnt:
                                rap((b, k, cnt, q))
                                q += cnt
                            eobrun -= 1
                            break
                        t = za[oz + zb[o + k] + r]  # the zero the symbol lands on
                        cnt = t - k - r if t < nb else nf[o + k]
                        if cnt:
                            rap((b, k, cnt, q))
                            q += cnt
                        if e & 15:
                            if t >= nb:
                                raise IndexError
                            nap((b, t, sign))
                        k = t + 1
                if q > seg_end[s]:
                    raise IndexError
        except IndexError:
            self._truncated()
        p1 = 1 << Al
        if runs:
            rb, rk, rc, rq = np.array(runs).T
            i = np.arange(rc.sum()) - np.repeat(np.cumsum(rc) - rc, rc)
            b = np.repeat(rb, rc)
            nz_at = np.full((n, nb), nb)  # the band's non-zeros in order
            rr, kk = np.nonzero(nz)
            nz_at[rr, kk - zeros_before[rr, kk]] = kk
            k = nz_at[b, np.repeat(rk - zeros_before[rb, rk], rc) + i]
            bit = win[np.repeat(rq, rc) + i] >> 15
            cur = band[b, k]
            fix = (bit == 1) & ((cur & p1) == 0)
            band[b[fix], k[fix]] = cur[fix] + np.where(cur[fix] >= 0, p1, -p1)
        if new:
            nb_, nk, nq = np.array(new).T
            band[nb_, nk] = np.where(win[nq] >> 15, p1, -p1)
        c.coefs.reshape(-1, 64)[flat, Ss : Se + 1] = band

    def output(self) -> np.ndarray:
        planes = []
        for c in self.comps:
            if c.qtable is None:
                self.fail("missing quantisation table")
            nat = np.zeros(c.coefs.shape, np.int64)
            nat[..., NATURAL_ORDER] = c.coefs
            nat *= c.qtable
            br, bc = nat.shape[:2]
            samples = _idct_islow(nat.reshape(-1, 8, 8)).reshape(br, bc, 8, 8)
            plane = samples.transpose(0, 2, 1, 3).reshape(br * 8, bc * 8)[: c.hgt, : c.w]
            planes.append(_upsample(plane, self.vmax // c.v, self.hmax // c.h)[: self.height, : self.width])
        if len(planes) == 1:
            return planes[0]
        if len(planes) == 4:  # libjpeg's CMYK out, inverted as PIL's "CMYK;I" reads it
            if self.adobe is not None and self.adobe != 0:  # YCCK
                return np.concatenate([_ycc_to_rgb(*planes[:3]), 255 - planes[3][..., None]], axis=-1)
            return 255 - np.stack(planes, axis=-1)
        if self.jfif:
            rgb = False
        elif self.adobe is not None:
            rgb = self.adobe == 0
        else:
            rgb = [c.cid for c in self.comps] == [82, 71, 66]  # 'R', 'G', 'B'
        if rgb:
            return np.stack(planes, axis=-1)
        return _ycc_to_rgb(*planes)


def read_jpeg(path: str) -> np.ndarray:
    """Decode a JPEG file to (H, W, 3) uint8 RGB, (H, W) uint8 grey or
    (H, W, 4) uint8 CMYK, as PIL with libjpeg-turbo does (module
    docstring)."""
    with open(path, "rb") as f:
        buf = f.read()
    return _Decoder(buf, str(path)).decode()


# PIL's other image families, told apart by their signature: refused
_OTHER_FAMILIES = ((b"BM", "BMP"), (b"GIF87a", "GIF"), (b"GIF89a", "GIF"))


def decode_image(buf: bytes, path: str = "<bytes>", palette: bool = False) -> np.ndarray:
    """PNG, JPEG or TIFF bytes, told apart by their signature, decoded as
    ``np.asarray(PIL.Image.open(...))`` gives them; with ``palette``,
    palette PNGs as RGB through their palette, as imageio reads them (the
    renderer's textures; imageio reads a ``.tif`` texture with tifffile,
    which keeps the indices, as PIL does).  BMP, GIF and WebP (which PIL
    also reads) raise ``NotImplementedError``, anything else
    ``ValueError``, naming ``path``."""
    if buf[:8] == PNG_SIGNATURE:
        return decode_png(buf, path, palette)
    if buf[:3] == SIGNATURE:
        return _Decoder(buf, path).decode()
    if buf[:2] in (b"II", b"MM"):
        return decode_tiff(buf, path)
    family = next((name for sig, name in _OTHER_FAMILIES if buf.startswith(sig)), None)
    if buf[:4] == b"RIFF" and buf[8:12] == b"WEBP":
        family = "WebP"
    if family is not None:
        raise NotImplementedError(f"{path}: {family} images are not supported (PNG, JPEG and TIFF only)")
    raise ValueError(f"{path}: neither a PNG, a JPEG nor a TIFF file")


def read_image(path: str) -> np.ndarray:
    """The port's ``_load_im``: a PNG, JPEG or TIFF file (data/png.py,
    this module, data/tiff.py), decoded by ``decode_image``."""
    with open(path, "rb") as f:
        return decode_image(f.read(), str(path))


# ------------------------------------------------------------------ encoding
# Annex K.1 quantisation tables (natural order) and K.3 Huffman tables
# (jcparam.c std_luminance_quant_tbl / std_chrominance_quant_tbl,
# std_huff_tables)
QUANT_TABLES = (
    np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69, 56,
              14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
              49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99]),
    np.array([17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99, 99, 99, 99, 99,
              47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32),
)
_AC_LUMA = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a25262728"
    "292a3435363738393a434445464748494a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2"
    "e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")
_AC_CHROMA = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f11718191a"
    "262728292a35363738393a434445464748494a535455565758595a636465666768696a737475767778797a8283848586"
    "8788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9"
    "dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")
# (class, id): (counts of codes of length 1..16, symbols), in the order
# libjpeg writes the DHT segments
HUFFMAN_TABLES = {
    (0, 0): (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]), bytes(range(12))),
    (1, 0): (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]), _AC_LUMA),
    (0, 1): (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]), bytes(range(12))),
    (1, 1): (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]), _AC_CHROMA),
}


def _quant_tables(quality: int) -> list[np.ndarray]:
    """The Annex K tables scaled as jcparam.c's jpeg_set_quality scales them
    with force_baseline (entries clamped to 1..255)."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return [np.clip((q * scale + 50) // 100, 1, 255) for q in QUANT_TABLES]


def _fix(x: float) -> int:
    return int(x * 65536 + 0.5)


def _rgb_to_ycc(rgb: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """jccolor.c rgb_ycc_convert: 16-bit fixed point, Y rounded with
    ONE_HALF, Cb and Cr with ONE_HALF - 1."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half, offset = 1 << 15, 128 << 16
    y = (_fix(0.299) * r + _fix(0.587) * g + _fix(0.114) * b + half) >> 16
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b + offset + half - 1) >> 16
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b + offset + half - 1) >> 16
    return y, cb, cr


def _pad(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Replicate the last row and column out to (rows, cols), as
    expand_right_edge and expand_bottom_edge do."""
    return np.pad(plane, ((0, rows - plane.shape[0]), (0, cols - plane.shape[1])), mode="edge")


def _downsample_h2v2(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """jcsample.c h2v2_downsample of a full-size plane to (rows, cols): the
    plane padded to an even height and to 2 * cols wide, each 2 x 2 sum
    plus a bias alternating 1, 2, 1, ... along the row, shifted by 2; the
    result's last row replicated down to ``rows``."""
    H = plane.shape[0] + plane.shape[0] % 2
    p = _pad(plane, H, 2 * cols)
    s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
    bias = 1 + (np.arange(cols) & 1)
    return _pad((s + bias) >> 2, rows, cols)


def _fdct_1d(x: list, out_shift: int, even_shift: int) -> list:
    """One pass of jfdctint.c's jpeg_fdct_islow over axis 0 of ``x`` (a
    list of 8 int64 arrays): 13-bit constants, the even outputs scaled by
    2^-even_shift (a left shift when negative), the odd ones by
    2^-out_shift, each rounded as DESCALE rounds."""
    def descale(v, n):
        return (v + (1 << (n - 1))) >> n

    tmp0, tmp7 = x[0] + x[7], x[0] - x[7]
    tmp1, tmp6 = x[1] + x[6], x[1] - x[6]
    tmp2, tmp5 = x[2] + x[5], x[2] - x[5]
    tmp3, tmp4 = x[3] + x[4], x[3] - x[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out = [None] * 8
    if even_shift < 0:
        out[0], out[4] = (tmp10 + tmp11) << -even_shift, (tmp10 - tmp11) << -even_shift
    else:
        out[0], out[4] = descale(tmp10 + tmp11, even_shift), descale(tmp10 - tmp11, even_shift)
    z1 = (tmp12 + tmp13) * 4433
    out[2] = descale(z1 + tmp13 * 6270, out_shift)
    out[6] = descale(z1 - tmp12 * 15137, out_shift)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * 9633
    tmp4, tmp5, tmp6, tmp7 = tmp4 * 2446, tmp5 * 16819, tmp6 * 25172, tmp7 * 12299
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    out[7] = descale(tmp4 + z1 + z3, out_shift)
    out[5] = descale(tmp5 + z2 + z4, out_shift)
    out[3] = descale(tmp6 + z2 + z3, out_shift)
    out[1] = descale(tmp7 + z1 + z4, out_shift)
    return out


def _fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """(..., 8, 8) level-shifted samples -> the islow DCT, scaled by 8 as
    libjpeg leaves it (CONST_BITS 13, PASS1_BITS 2)."""
    rows = _fdct_1d([blocks[..., i] for i in range(8)], 11, -2)  # pass 1: along each row
    rows = np.stack(rows, axis=-1)
    cols = _fdct_1d([rows[..., i, :] for i in range(8)], 15, 2)  # pass 2: down each column
    return np.stack(cols, axis=-2)


def _quantize(coef: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """jcdctmgr.c's quantize with compute_reciprocal's divisors for
    16-bit DCT elements: the divisor q * 8, |x| + a rounding correction,
    times a reciprocal, shifted; the sign restored."""
    recip, corr, shift = np.zeros(64, np.int64), np.zeros(64, np.int64), np.zeros(64, np.int64)
    for i, q in enumerate(qtable.reshape(-1)):
        d = int(q) << 3
        r = 16 + d.bit_length() - 1
        fq, fr, c = (1 << r) // d, (1 << r) % d, d // 2
        if fr == 0:  # a power of two
            fq, r = fq >> 1, r - 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        recip[i], corr[i], shift[i] = fq, c, r
    a = coef.reshape(*coef.shape[:-2], 64)
    q = ((np.abs(a) + corr) * recip) >> shift
    return np.where(a < 0, -q, q)


def _huffman_codes(counts: bytes, symbols: bytes) -> tuple[np.ndarray, np.ndarray]:
    """Canonical Huffman codes: (code, length) per symbol value 0..255."""
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for n in range(1, 17):
        for _ in range(counts[n - 1]):
            code_of[symbols[k]], len_of[symbols[k]] = code, n
            code, k = code + 1, k + 1
        code <<= 1
    return code_of, len_of


def _entropy_code(mcu: np.ndarray, table: np.ndarray, comp: np.ndarray) -> bytes:
    """Baseline Huffman coding of the blocks ``mcu`` (N, 64), zigzag order,
    in scan order: DC differences per component, AC run/size symbols with
    ZRL and EOB, the magnitude bits after each symbol, 1-padding to a byte
    and 0xFF stuffing.  The symbols and bits of the whole scan are laid
    out at once in numpy."""
    codes = {k: _huffman_codes(*v) for k, v in HUFFMAN_TABLES.items()}

    def lookup(cls, sym, t):
        c0, c1 = codes[cls, 0], codes[cls, 1]
        return np.where(t == 0, c0[0][sym], c1[0][sym]), np.where(t == 0, c0[1][sym], c1[1][sym])

    def size_of(v):
        a = np.abs(v)
        s = np.zeros(v.shape, np.int64)
        while (a >> s).any():
            s += (a >> s) > 0
        return s

    def extra(v, s):
        return np.where(v >= 0, v, v + (1 << s) - 1)

    nb = len(mcu)
    dc = mcu[:, 0].copy()
    for c in range(3):
        sel = comp == c
        dc[sel] = np.diff(np.concatenate([[0], mcu[sel, 0]]))
    # items: (block, order key within the block, code, code length, extra bits, extra length)
    s = size_of(dc)
    items = [(np.arange(nb), np.zeros(nb, np.int64), *lookup(0, s, table), extra(dc, s), s)]
    b, k = np.nonzero(mcu[:, 1:])
    k = k + 1
    first = np.r_[True, b[1:] != b[:-1]]
    prev = np.where(first, 0, np.r_[0, k[:-1]])
    run = k - prev - 1
    v = mcu[b, k]
    s = size_of(v)
    items.append((b, 2 * k, *lookup(1, (run % 16) * 16 + s, table[b]), extra(v, s), s))
    nz = run // 16  # ZRL symbols before the coefficient
    zb, zk = np.repeat(b, nz), np.repeat(2 * k - 1, nz)
    items.append((zb, zk, *lookup(1, np.full_like(zb, 0xF0), table[zb]), 0 * zb, 0 * zb))
    last = np.zeros(nb, np.int64)
    np.maximum.at(last, b, k)
    eb = np.flatnonzero(last < 63)
    items.append((eb, np.full_like(eb, 200), *lookup(1, 0 * eb, table[eb]), 0 * eb, 0 * eb))
    blk, key, code, clen, ext, elen = (np.concatenate(a) for a in zip(*items))
    order = np.lexsort((key, blk))
    value = (code[order] << elen[order]) | (ext[order] & ((1 << elen[order]) - 1))
    nbits = (clen + elen)[order]
    total = int(nbits.sum())
    starts = np.cumsum(nbits) - nbits
    within = np.arange(total) - np.repeat(starts, nbits)
    bits = (np.repeat(value, nbits) >> (np.repeat(nbits, nbits) - 1 - within)) & 1
    bits = np.concatenate([bits, np.ones(-total % 8, np.int64)]).astype(np.uint8)
    return np.packbits(bits).tobytes().replace(b"\xff", b"\xff\x00")


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(8R, 8C) samples -> (R, C, 8, 8) blocks, level-shifted by 128."""
    R, C = plane.shape[0] // 8, plane.shape[1] // 8
    return plane.reshape(R, 8, C, 8).transpose(0, 2, 1, 3) - 128


def encode_jpeg(rgb: np.ndarray, quality: int = 95) -> bytes:
    """(H, W, 3) uint8 RGB -> baseline JFIF bytes as libjpeg(-turbo) writes
    them at PIL's defaults (``PIL.Image.save(..., quality=quality)``,
    ``imageio.imwrite(..., quality=quality)``): YCbCr by jccolor.c's fixed
    point, 4:2:0 by h2v2_downsample, the islow FDCT, jcdctmgr.c's
    quantiser, the Annex K tables scaled for ``quality`` with
    force_baseline, the standard Huffman tables, no restart interval.  The
    edge blocks are padded as libjpeg pads them, and the luma blocks past
    the image in the last MCU column or row are its dummy blocks (the DC
    of the block before them, no AC)."""
    rgb = np.asarray(rgb)
    if rgb.ndim != 3 or rgb.shape[2] != 3 or rgb.dtype != np.uint8:
        raise ValueError(f"cannot encode a {rgb.dtype} array of shape {rgb.shape} as an RGB JPEG")
    H, W = rgb.shape[:2]
    my, mx = -(-H // 16), -(-W // 16)  # MCUs of 16 x 16
    yr, yc = -(-H // 8), -(-W // 8)  # luma blocks inside the image
    quant = _quant_tables(quality)
    y, cb, cr = _rgb_to_ycc(rgb)
    yq = _quantize(_fdct_islow(_blocks(_pad(y, 8 * yr, 8 * yc))), quant[0])
    luma = np.zeros((2 * my, 2 * mx, 64), np.int64)
    luma[:yr, :yc] = yq[..., NATURAL_ORDER]
    if yc < 2 * mx:  # dummy right column: the DC of the block on its left
        luma[:yr, yc, 0] = luma[:yr, yc - 1, 0]
    if yr < 2 * my:  # dummy bottom row: the DC of the MCU's top-right block
        luma[yr, :, 0] = np.repeat(luma[yr - 1, 1::2, 0], 2)
    chroma = [_quantize(_fdct_islow(_blocks(_downsample_h2v2(p, 8 * my, 8 * mx))), quant[1])[..., NATURAL_ORDER]
              for p in (cb, cr)]
    yb = luma.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(my, mx, 4, 64)
    mcu = np.concatenate([yb, chroma[0][:, :, None], chroma[1][:, :, None]], axis=2).reshape(-1, 64)
    comp = np.tile([0, 0, 0, 0, 1, 2], my * mx)
    data = _entropy_code(mcu, np.minimum(comp, 1), comp)

    def seg(marker, payload):
        return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload

    out = [b"\xff\xd8", seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t, q in enumerate(quant):
        out.append(seg(0xDB, bytes([t]) + bytes(q[NATURAL_ORDER].astype(np.uint8))))
    out.append(seg(0xC0, struct.pack(">BHHB", 8, H, W, 3) + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for (tc, th), (counts, symbols) in HUFFMAN_TABLES.items():
        out.append(seg(0xC4, bytes([tc << 4 | th]) + counts + symbols))
    out.append(seg(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    return b"".join(out) + data + b"\xff\xd9"


def write_jpeg(path: str, rgb: np.ndarray, quality: int = 95) -> None:
    """Write ``rgb`` to ``path`` as ``encode_jpeg`` encodes it."""
    with open(path, "wb") as fh:
        fh.write(encode_jpeg(rgb, quality))
