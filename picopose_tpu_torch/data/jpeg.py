"""Baseline JPEG decoding on numpy, and ``read_image``.

The port's counterpart of what picopose_tpu/data/bop.py::_load_im (:56-67)
gets from PIL for a ``.jpg``: the MegaPose shards' ``rgb.jpg`` frames and
BOP test frames stored as ``rgb/*.jpg``.  The arrays are those
``np.asarray(PIL.Image.open(path))`` gives with PIL's libjpeg-turbo:
(H, W, 3) uint8 RGB, or (H, W) for greyscale.

Read: sequential Huffman JPEG (SOF0, and SOF1 at 8 bits), 1 or 3
components, sampling factors up to 2 x 2 (4:4:4, 4:2:2, 4:2:0, 4:4:0),
interleaved or one scan per component, restart intervals, APPn and COM
segments skipped, an Adobe APP14 transform flag honoured.  Progressive,
arithmetic, lossless and hierarchical files, 12-bit samples and CMYK
raise ``NotImplementedError`` naming the file; a truncated or corrupt
stream raises ``ValueError`` naming it.

The arithmetic is libjpeg-turbo's at its defaults (jpeg-6b semantics):

  * the islow integer IDCT (jidctint.c: 13-bit constants, 2 extra bits
    between the passes, the result wrapped to 10 bits and clamped through
    the range-limit table);
  * "fancy" triangular upsampling (jdsample.c): h2v1 (3a + b + 1) >> 2 and
    (3a + b + 2) >> 2; h1v2 the same vertically; h2v2 a vertical 3a + b
    pass, then (3s + t + 8) >> 4 and (3s + t + 7) >> 4, with the first
    and last column (4s + 8) >> 4 and (4s + 7) >> 4; rows above the first
    and below the last repeat them; a component 2 samples wide or less
    is replicated instead;
  * YCbCr -> RGB by jdcolor.c's 16-bit fixed-point tables, rounding with
    ONE_HALF, clamped.

Entropy decoding is serial.  The 16-bit window at every bit position of
a scan is computed in numpy, and per Huffman table a 65536-entry list
gives each window's bit count (code and value bits) and, for AC tables,
the step it adds to the coefficient index; the Python loop then only
chases symbol positions.  Coefficient values,
dequantisation, the IDCT, upsampling and colour conversion run vectorised
over all blocks at once.
"""

from __future__ import annotations

import re
import struct

import numpy as np

from picopose_tpu_torch.data.png import SIGNATURE as PNG_SIGNATURE
from picopose_tpu_torch.data.png import read_png

SIGNATURE = b"\xff\xd8\xff"
# zigzag index -> natural (row-major) index (jutils.c jpeg_natural_order)
NATURAL_ORDER = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])
_SOF_NAMES = {0xC2: "progressive", 0xC3: "lossless", 0xC5: "hierarchical", 0xC6: "hierarchical",
              0xC7: "hierarchical", 0xC9: "arithmetic", 0xCA: "arithmetic", 0xCB: "arithmetic",
              0xCD: "arithmetic", 0xCE: "arithmetic", 0xCF: "arithmetic"}
_END_OF_SCAN = re.compile(rb"\xff[^\x00]")
_EOB = 64  # AC step of an end-of-block symbol: ends the block whatever k is
_SHIFT = 7  # AC step entries pack bits << 7 | step
_FAR = 1 << 40  # the bits an invalid code "takes"


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.w = self.hgt = 0  # downsampled size, set with the frame
        self.coefs: np.ndarray | None = None  # (rows, cols, 64) zigzag, int16


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
        if not self.comps or any(c.coefs is None for c in self.comps):
            raise ValueError(f"{self.path}: truncated JPEG (a component has no scan)")
        return self.output()

    def segment(self, marker: int, seg: bytes) -> None:
        if marker in (0xC0, 0xC1):
            self.frame(seg)
        elif marker in _SOF_NAMES:
            raise NotImplementedError(f"{self.path}: {_SOF_NAMES[marker]} JPEG is not supported (baseline only)")
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
            raise NotImplementedError(f"{self.path}: arithmetic-coded JPEG is not supported (baseline only)")
        elif marker == 0xDC:
            raise NotImplementedError(f"{self.path}: JPEG with a DNL marker is not supported")
        # other APPn, COM and unknown segments are skipped

    def frame(self, seg: bytes) -> None:
        if len(seg) < 6:
            self.fail("SOF")
        precision, self.height, self.width, n = struct.unpack(">BHHB", seg[:6])
        if precision != 8:
            raise NotImplementedError(f"{self.path}: {precision}-bit JPEG is not supported (8-bit only)")
        if n not in (1, 3):
            raise NotImplementedError(f"{self.path}: JPEG with {n} components is not supported (grey or 3 only)")
        if self.height == 0:
            raise NotImplementedError(f"{self.path}: JPEG with a DNL marker is not supported")
        if self.width == 0 or len(seg) < 6 + 3 * n:
            self.fail("SOF")
        for i in range(n):
            cid, hv, tq = seg[6 + 3 * i : 9 + 3 * i]
            h, v = hv >> 4, hv & 15
            if not (1 <= h <= 2 and 1 <= v <= 2):
                raise NotImplementedError(f"{self.path}: sampling factors {h}x{v} are not supported (up to 2x2)")
            self.comps.append(_Component(cid, h, v, tq))
        if n == 1:  # a lone component's factors are ignored (its plane is the image)
            self.comps[0].h = self.comps[0].v = 1
        self.hmax = max(c.h for c in self.comps)
        self.vmax = max(c.v for c in self.comps)
        self.mcux = -(-self.width // (8 * self.hmax))
        self.mcuy = -(-self.height // (8 * self.vmax))
        for c in self.comps:
            c.w = -(-self.width * c.h // self.hmax)
            c.hgt = -(-self.height * c.v // self.vmax)

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
        by_id = {c.cid: c for c in self.comps}
        members = []
        for i in range(ns):
            cid, t = seg[1 + 2 * i : 3 + 2 * i]
            if cid not in by_id or (0, t >> 4) not in self.huff or (1, t & 15) not in self.huff:
                self.fail("SOS names an unknown component or table")
            members.append((by_id[cid], t >> 4, t & 15))
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
        self.entropy_decode(members, segments)
        return pos

    def entropy_decode(self, members, segments) -> None:
        if len(members) == 1:  # non-interleaved: an MCU is one block of the component's own grid
            c = members[0][0]
            rows, cols = -(-c.hgt // 8), -(-c.w // 8)
            pattern = [0]
        else:  # each member's v x h blocks, row by row
            rows, cols = self.mcuy, self.mcux
            pattern = [i for i, (c, _, _) in enumerate(members) for _ in range(c.v * c.h)]
        n_mcu = rows * cols
        ri = self.restart or n_mcu
        n_seg = -(-n_mcu // ri)
        if len(segments) < n_seg:
            raise ValueError(f"{self.path}: truncated JPEG (restart intervals missing)")
        data = b"".join(segments[:n_seg])
        seg_bits = np.cumsum([0] + [8 * len(s) for s in segments[:n_seg]])
        # the 16-bit window at every bit position (zero bits past the end)
        b = np.frombuffer(data + bytes(8), np.uint8).astype(np.int32)
        w24 = (b[:-2] << 16) | (b[1:-1] << 8) | b[2:]
        win = ((w24[:, None] >> np.arange(8, 0, -1, dtype=np.int32)) & 0xFFFF).astype(np.uint16).ravel()
        plan = [(self.steps[0, members[i][1]], self.steps[1, members[i][2]]) for i in pattern]
        # the serial part: chase symbol positions
        dcpos, acpos, ends = [], [], []
        dap, aap, eap = dcpos.append, acpos.append, ends.append
        w = memoryview(win)
        seg_end = seg_bits[1:].tolist()
        try:
            for s in range(n_seg):
                q = int(seg_bits[s])
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
            raise ValueError(f"{self.path}: truncated or corrupt JPEG (scan data ends inside an MCU)") from None
        self.coefficients(members, pattern, (rows, cols), ri, win, np.array(dcpos), np.array(acpos), np.array(ends))

    def coefficients(self, members, pattern, grid, ri, win, dcpos, acpos, ends) -> None:
        """Values at the recorded symbol positions -> each component's
        zigzag coefficient blocks."""
        rows, cols = grid
        nper = len(pattern)
        n_blocks = len(dcpos)
        comp_of_block = np.tile(np.array(pattern), n_blocks // nper)
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
        # DC differences, accumulated per component and restart interval
        diffs = np.zeros(n_blocks, np.int64)
        for i, (_, td, _) in enumerate(members):
            sel = comp_of_block == i
            L, S = self.huff[0, td]
            w = win[dcpos[sel]]
            ln, sz = L[w], S[w]
            diffs[sel] = _extend(win[dcpos[sel] + ln] >> (16 - sz), sz)
        interval = np.arange(n_blocks) // (ri * nper)
        for i, (c, _, _) in enumerate(members):
            sel = comp_of_block == i
            d, grp = diffs[sel], interval[sel]
            cs = np.cumsum(d)
            starts = np.flatnonzero(np.diff(np.concatenate([[-1], grp])))
            base = np.repeat(cs[starts] - d[starts], np.diff(np.concatenate([starts, [len(d)]])))
            zz[sel, 0] = cs - base
            # place the blocks on the component's grid
            blocks = zz[sel].astype(np.int16)
            if c.coefs is None:
                c.coefs = np.zeros((self.mcuy * c.v, self.mcux * c.h, 64), np.int16)
            if len(members) == 1:
                c.coefs[:rows, :cols] = blocks.reshape(rows, cols, 64)
            else:
                c.coefs[:] = blocks.reshape(rows, cols, c.v, c.h, 64).transpose(0, 2, 1, 3, 4).reshape(
                    rows * c.v, cols * c.h, 64)

    def output(self) -> np.ndarray:
        planes = []
        for c in self.comps:
            if c.tq not in self.qt:
                self.fail("missing quantisation table")
            nat = np.zeros(c.coefs.shape, np.int64)
            nat[..., NATURAL_ORDER] = c.coefs
            nat *= self.qt[c.tq]
            br, bc = nat.shape[:2]
            samples = _idct_islow(nat.reshape(-1, 8, 8)).reshape(br, bc, 8, 8)
            plane = samples.transpose(0, 2, 1, 3).reshape(br * 8, bc * 8)[: c.hgt, : c.w]
            planes.append(_upsample(plane, self.vmax // c.v, self.hmax // c.h)[: self.height, : self.width])
        if len(planes) == 1:
            return planes[0]
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
    """Decode a baseline JPEG file to (H, W, 3) uint8 RGB or (H, W) uint8
    grey, as PIL with libjpeg-turbo does (module docstring)."""
    with open(path, "rb") as f:
        buf = f.read()
    return _Decoder(buf, str(path)).decode()


def read_image(path: str) -> np.ndarray:
    """The port's ``_load_im``: a PNG or JPEG file, told apart by its
    signature, decoded as ``np.asarray(PIL.Image.open(path))`` gives it.
    TIFF raises NotImplementedError (not ported yet); anything else
    ValueError, naming the file."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head == PNG_SIGNATURE:
        return read_png(path)
    if head[:3] == SIGNATURE:
        return read_jpeg(path)
    if head[:4] in (b"II*\x00", b"MM\x00*"):
        raise NotImplementedError(f"{path}: TIFF images are not supported by the port (PNG and JPEG only)")
    raise ValueError(f"{path}: neither a PNG nor a JPEG file")
