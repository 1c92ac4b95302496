"""The port's PNG decoder (data/png.py) against PIL, bitwise.

Files written by PIL (its own choice of scanline filters per row) and by
a test encoder that writes every row with one filter type (0-4) or cycles
through all five, with the image data split over several IDAT chunks:
8-bit grey, RGB and RGBA and 16-bit grey, at several sizes, random and
smooth content.  The decoded array must equal ``np.asarray(Image.open())``
in dtype, shape and every value (tolerance: none).  Interlaced, palette,
grey+alpha and 16-bit colour PNGs, which the decoder once refused, decode
as PIL decodes them (every colour type, depth and interlace in
tests/test_torch_formats.py); JPEG and TIFF paths, a bad CRC and an
unknown filter type must raise.
"""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image
from torch_image_files import png_bytes

from picopose_tpu_torch.data.png import decode_png, read_png

MODES = {"L": (1, 8), "RGB": (3, 8), "RGBA": (4, 8), "I;16": (1, 16)}
SIZES = [(1, 1), (7, 5), (31, 64), (120, 97)]


def image(mode, hw, seed, smooth=False):
    rng = np.random.default_rng(seed)
    ch, depth = MODES[mode]
    shape = hw if ch == 1 else (*hw, ch)
    top = 65536 if depth == 16 else 256
    if smooth:  # gradients with a little noise: other filters than on noise
        yy, xx = np.mgrid[: hw[0], : hw[1]]
        base = (yy * 3 + xx * 5) % top
        if ch > 1:
            base = base[..., None] + np.arange(ch) * 40
        arr = (base + rng.integers(0, 3, shape)) % top
    else:
        arr = rng.integers(0, top, shape)
    return arr.astype(np.uint16 if depth == 16 else np.uint8)


def encode(arr, filters, depth=8, colour=None, interlace=0, idat_split=3):
    """A PNG whose row y uses filter filters[y % len(filters)]."""
    H, W = arr.shape[:2]
    ch = 1 if arr.ndim == 2 else arr.shape[2]
    colour = {1: 0, 2: 4, 3: 2, 4: 6}[ch] if colour is None else colour
    b = arr.astype(">u2").view(np.uint8).reshape(H, W, -1) if depth == 16 else arr.reshape(H, W, ch)
    x = b.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    pa, pb, pc = np.abs(up - c), np.abs(a - c), np.abs(a + up - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, up, c))
    preds = [0 * x, a, up, (a + up) >> 1, paeth]
    rows = b"".join(
        bytes([filters[y % len(filters)]]) + ((x[y] - preds[filters[y % len(filters)]][y]) & 255).astype(np.uint8).tobytes()
        for y in range(H)
    )
    data = zlib.compress(rows, 6)
    cuts = np.linspace(0, len(data), idat_split + 1).astype(int)
    chunk = lambda k, d: struct.pack(">I", len(d)) + k + d + struct.pack(">I", zlib.crc32(k + d))
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, colour, 0, 0, interlace))
    out += b"".join(chunk(b"IDAT", data[s:e]) for s, e in zip(cuts[:-1], cuts[1:]))
    return out + chunk(b"IEND", b"")


def pil_array(path):
    with Image.open(path) as im:
        return np.asarray(im)


def assert_same(got, ref):
    assert got.dtype == ref.dtype and got.shape == ref.shape, (got.dtype, got.shape, ref.dtype, ref.shape)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("smooth", [False, True], ids=["noise", "smooth"])
@pytest.mark.parametrize("mode", list(MODES))
def test_files_written_by_pil(tmp_path, mode, smooth):
    for i, hw in enumerate(SIZES):
        path = str(tmp_path / f"{i}.png")
        Image.fromarray(image(mode, hw, i, smooth)).save(path)
        assert_same(read_png(path), pil_array(path))


@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4], [4, 3, 2], [2, 2, 3, 1, 4]],
                         ids=lambda f: "".join(map(str, f)))
@pytest.mark.parametrize("mode", list(MODES))
def test_each_filter_type_and_split_image_data(tmp_path, mode, filters):
    for i, hw in enumerate(SIZES):
        arr = image(mode, hw, 10 + i, smooth=i % 2 == 1)
        path = tmp_path / f"{i}.png"
        path.write_bytes(encode(arr, filters, depth=MODES[mode][1], idat_split=1 + i))
        got = read_png(str(path))
        assert_same(got, pil_array(path))
        assert_same(got, arr)


def test_unsupported_files_raise_naming_the_file(tmp_path):
    """JPEG and TIFF paths raise, naming the file; the PNGs this test once
    saw refused (interlaced, grey+alpha, 16-bit RGB, palette) decode as
    PIL decodes them."""
    rgb = image("RGB", (16, 16), 0)
    cases = {
        "interlaced.png": png_bytes(rgb, 2, 8, interlace=True),
        "grey_alpha.png": encode(image("RGB", (16, 16), 1)[..., :2], [0]),
        "rgb16.png": encode(rgb.astype(np.uint16) * 257, [0], depth=16),
    }
    for name, data in cases.items():
        (tmp_path / name).write_bytes(data)
    Image.fromarray(rgb).convert("P").save(tmp_path / "palette.png")
    Image.fromarray(rgb).save(tmp_path / "frame.jpg")
    Image.fromarray(rgb[..., 0]).save(tmp_path / "frame.tif")
    for name in [*cases, "palette.png"]:
        path = str(tmp_path / name)
        assert_same(read_png(path), pil_array(path))
    for name in ["frame.jpg", "frame.tif"]:
        with pytest.raises(NotImplementedError, match=name):
            read_png(str(tmp_path / name))


def test_corrupt_files_raise():
    good = encode(image("RGB", (8, 8), 0), [4])
    bad_crc = bytearray(good)
    bad_crc[40] ^= 1  # inside the first IDAT chunk's data
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bytes(bad_crc))
    raw = zlib.decompress(b"".join(
        good[p + 8 : p + 8 + struct.unpack(">I", good[p : p + 4])[0]]
        for p in [i for i in range(8, len(good) - 4) if good[i + 4 : i + 8] == b"IDAT"]
    ))
    unknown = bytearray(raw)
    unknown[0] = 5
    data = zlib.compress(bytes(unknown))
    chunk = lambda k, d: struct.pack(">I", len(d)) + k + d + struct.pack(">I", zlib.crc32(k + d))
    png = good[:33] + chunk(b"IDAT", data) + chunk(b"IEND", b"")
    with pytest.raises(ValueError, match="filter"):
        decode_png(png)
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a" + good[6:])
