"""The port's image decoders (picopose_tpu_torch/data/{jpeg,png,tiff}.py) on
every PNG, JPEG and TIFF variant the JAX package reads through PIL
(picopose_tpu/data/bop.py::_load_im), against
``np.asarray(PIL.Image.open(path))``: the same dtype (in native byte
order), shape and every value (float samples compared as bits).

Files, built once per module (``files``): written by PIL where it writes
the variant (progressive, CMYK and YCCK JPEGs; cv2's 4:1:1 and progressive
JPEGs; LZW, Deflate and PackBits TIFFs in every mode PIL saves, with the
horizontal predictor and as BigTIFF); otherwise by numpy + zlib
(tests/torch_image_files.py: Adam7-interlaced and sub-byte PNGs; tiled,
planar, big-endian, 12-bit, float-predictor and premultiplied TIFFs;
``_jpeg_with_factors`` here: baseline JPEGs at sampling factors up to 4,
from the port's encoder pieces), each first checked to open in PIL.  The
variants still refused raise ``NotImplementedError`` naming the file, and
a BOP tree whose frames are rewritten in the new formats loads the same
``ImageRecord``s (frames, crops) through the port's and the JAX package's
``bop`` loaders.
"""

import io
import os
import shutil
import struct

import cv2
import numpy as np
import pytest
from PIL import Image
from torch_bop_tree import write_bop_tree
from torch_image_files import png_bytes, tiff_bytes

from picopose_tpu.data import bop as jbop
from picopose_tpu_torch.data import bop
from picopose_tpu_torch.data import jpeg as J
from picopose_tpu_torch.data.jpeg import decode_image, read_image

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _image(hw, seed=0, channels=3):
    """Smooth colour waves plus noise: many non-zero coefficients."""
    rng = np.random.default_rng(seed)
    H, W = hw
    yy, xx = np.mgrid[:H, :W]
    img = np.stack([128 + 90 * np.sin(xx / (5 + c) + c) * np.cos(yy / (9 - c)) for c in range(channels)], -1)
    img = np.clip(img + rng.normal(0, 18, (H, W, channels)), 0, 255).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def _pil(arr, fmt, mode=None, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, fmt, **kw)
    return buf.getvalue()


def _cv2(arr, *params):
    ok, buf = cv2.imencode(".jpg", arr, list(params))
    assert ok
    return buf.tobytes()


def _jpeg_with_factors(rgb, factors, quality=90):
    """A baseline JFIF file of ``rgb`` whose components have the sampling
    factors ``factors`` ((h, v) of Y, Cb, Cr): each plane averaged down by
    its ratio to the largest factors, then the port's encoder pieces
    (jccolor, the islow FDCT, the quantiser, the standard Huffman tables)."""
    H, W = rgb.shape[:2]
    hmax, vmax = max(h for h, _ in factors), max(v for _, v in factors)
    mx, my = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    quant = J._quant_tables(quality)
    comps = []
    for ci, (plane, (h, v)) in enumerate(zip(J._rgb_to_ycc(rgb), factors)):
        fy, fx = vmax // v, hmax // h
        p = J._pad(plane, -(-H // fy) * fy, -(-W // fx) * fx)
        p = (p.reshape(p.shape[0] // fy, fy, p.shape[1] // fx, fx).sum((1, 3)) + fy * fx // 2) // (fy * fx)
        q = J._quantize(J._fdct_islow(J._blocks(J._pad(p, my * v * 8, mx * h * 8))), quant[min(ci, 1)])
        q = q[..., J.NATURAL_ORDER]
        comps.append(q.reshape(my, v, mx, h, 64).transpose(0, 2, 1, 3, 4).reshape(my, mx, v * h, 64))
    mcu = np.concatenate(comps, axis=2).reshape(-1, 64)
    comp = np.tile(np.repeat(np.arange(3), [h * v for h, v in factors]), my * mx)
    data = J._entropy_code(mcu, np.minimum(comp, 1), comp)

    def seg(marker, payload):
        return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload

    out = [b"\xff\xd8", seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    out += [seg(0xDB, bytes([t]) + bytes(q[J.NATURAL_ORDER].astype(np.uint8))) for t, q in enumerate(quant)]
    sof = b"".join(bytes([i + 1, h << 4 | v, min(i, 1)]) for i, (h, v) in enumerate(factors))
    out.append(seg(0xC0, struct.pack(">BHHB", 8, H, W, 3) + sof))
    out += [seg(0xC4, bytes([tc << 4 | th]) + c + s) for (tc, th), (c, s) in J.HUFFMAN_TABLES.items()]
    out.append(seg(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    return b"".join(out) + data + b"\xff\xd9"


def _with_adobe_transform(buf, transform):
    """The file with its Adobe APP14 segment's transform flag set."""
    at = buf.index(b"Adobe")
    return buf[: at + 11] + bytes([transform]) + buf[at + 12 :]


def _segments(buf):
    """(marker, start, end) of each marker segment and scan of a JPEG."""
    out, pos = [], 2
    while buf[pos + 1] != 0xD9:
        marker = buf[pos + 1]
        (length,) = struct.unpack(">H", buf[pos + 2 : pos + 4])
        end = pos + 2 + length
        if marker == 0xDA:  # the scan runs to the next marker that is not RSTn
            while not (buf[end] == 0xFF and buf[end + 1] not in (0x00, *range(0xD0, 0xD8))):
                end += 1
        out.append((marker, pos, end))
        pos = end
    return out


def _without_scan(buf, k):
    """The file without its k-th scan (SOS segment and entropy-coded data)."""
    scan = [s for s in _segments(buf) if s[0] == 0xDA][k]
    return buf[: scan[1]] + buf[scan[2] :]


RNG = np.random.default_rng(18)
RGB = RNG.integers(0, 256, (37, 45, 3), dtype=np.uint8)
SIZES = {"13x11": (11, 13), "1x1": (1, 1), "3x9": (9, 3), "33x2": (2, 33)}

JPEG = {
    # progressive (SOF2), PIL's scan script: spectral selection, successive approximation, EOB runs
    "progressive_420_q90": lambda: _pil(_image((90, 130), 1), "JPEG", quality=90, progressive=True),
    "progressive_444_q75": lambda: _pil(_image((90, 130), 2), "JPEG", quality=75, progressive=True, subsampling=0),
    "progressive_422_q75": lambda: _pil(_image((90, 130), 3), "JPEG", quality=75, progressive=True, subsampling=1),
    "progressive_q100": lambda: _pil(_image((64, 80), 4), "JPEG", quality=100, progressive=True),
    "progressive_grey": lambda: _pil(_image((45, 61), 5, 1), "JPEG", quality=85, progressive=True),
    "progressive_restart_every_3_mcus": lambda: _pil(_image((100, 130), 6), "JPEG", quality=90, progressive=True,
                                                     restart_marker_blocks=3),
    "progressive_restart_every_row": lambda: _pil(_image((100, 130), 7), "JPEG", quality=90, progressive=True,
                                                  restart_marker_rows=1),
    "progressive_17x33": lambda: _pil(_image((17, 33), 8), "JPEG", quality=95, progressive=True),
    "progressive_3x2": lambda: _pil(_image((3, 2), 9), "JPEG", quality=95, progressive=True),
    "progressive_adobe_rgb": lambda: _pil(_image((40, 50), 10), "JPEG", quality=90, progressive=True,
                                          keep_rgb=True, subsampling=0),
    "progressive_cv2": lambda: _cv2(_image((70, 90), 11), cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                                    cv2.IMWRITE_JPEG_QUALITY, 80),
    "progressive_committed_frame": lambda: open(os.path.join(DATA, "frame_progressive.jpg"), "rb").read(),
    # DC scans left out, so that DC stays unsent or unrefined, which
    # libjpeg-turbo does not smooth (a left-out AC scan breaks the history
    # the later refinement scans were coded against: a corrupt file)
    "progressive_without_dc_first": lambda: _without_scan(_pil(_image((45, 61), 26), "JPEG", quality=85,
                                                               progressive=True), 0),
    "progressive_without_dc_refine": lambda: _without_scan(_pil(_image((45, 61), 28), "JPEG", quality=85,
                                                                progressive=True), 6),
    # four components: Adobe CMYK (transform 0) and YCCK (transform 2)
    "cmyk": lambda: _pil(_image((40, 50), 12, 4), "JPEG", "CMYK", quality=90),
    "cmyk_progressive": lambda: _pil(_image((40, 50), 13, 4), "JPEG", "CMYK", quality=80, progressive=True),
    "ycck": lambda: _with_adobe_transform(_pil(_image((40, 50), 14, 4), "JPEG", "CMYK", quality=90), 2),
    "ycck_progressive": lambda: _with_adobe_transform(
        _pil(_image((40, 50), 15, 4), "JPEG", "CMYK", quality=90, progressive=True), 2),
    # sampling factors up to 4
    "411_cv2": lambda: _cv2(_image((40, 50), 16), cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411),
    "factors_4x1": lambda: _jpeg_with_factors(_image((45, 61), 17), [(4, 1), (1, 1), (1, 1)]),
    "factors_1x4": lambda: _jpeg_with_factors(_image((45, 61), 18), [(1, 4), (1, 1), (1, 1)]),
    "factors_4x2": lambda: _jpeg_with_factors(_image((45, 61), 19), [(4, 2), (1, 1), (1, 1)]),
    "factors_2x4": lambda: _jpeg_with_factors(_image((45, 61), 20), [(2, 4), (1, 1), (1, 1)]),
    "factors_4x1_2x1_1x1": lambda: _jpeg_with_factors(_image((45, 61), 21), [(4, 1), (2, 1), (1, 1)]),
    "factors_2x2_2x1_1x2": lambda: _jpeg_with_factors(_image((45, 61), 22), [(2, 2), (2, 1), (1, 2)]),
    "factors_4x1_7x5": lambda: _jpeg_with_factors(_image((5, 7), 23), [(4, 1), (1, 1), (1, 1)]),
}

PNG = {}
for _colour, _depths in {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}.items():
    for _depth in _depths:
        for _interlace in (False, True):
            for _size, (_h, _w) in SIZES.items():
                if _size != "13x11" and (_colour, _depth) not in ((0, 1), (2, 8), (3, 2), (6, 16)):
                    continue  # every size for a few kinds
                _spp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[_colour]
                PNG[f"colour{_colour}_{_depth}bit_{'adam7' if _interlace else 'plain'}_{_size}"] = (
                    lambda c=_colour, d=_depth, i=_interlace, h=_h, w=_w, s=_spp: png_bytes(
                        RNG.integers(0, 1 << d, (h, w, s)), c, d, i, bytes(range(256)) * 3 if c == 3 else None))

_TIFF_MODES = {
    "1": lambda: RNG.integers(0, 2, (37, 45)).astype(bool), "L": lambda: RGB[..., 0],
    "I;16": lambda: RNG.integers(0, 65536, (37, 45), dtype=np.uint16),
    "I": lambda: RNG.integers(-2**31, 2**31, (37, 45), dtype=np.int32),
    "F": lambda: RNG.normal(size=(37, 45)).astype(np.float32), "RGB": lambda: RGB,
    "RGBA": lambda: np.dstack([RGB, RGB[..., :1]]), "LA": lambda: RGB[..., :2], "CMYK": lambda: np.dstack([RGB, RGB[..., :1]]),
    "P": lambda: RGB[..., 0],
}


def _pil_tiff(mode, **kw):
    arr = _TIFF_MODES[mode]()
    im = Image.fromarray(arr, mode if mode in ("LA", "CMYK") else None)
    if mode == "P":
        im = im.convert("P")
    buf = io.BytesIO()
    im.save(buf, "TIFF", **kw)
    return buf.getvalue()


TIFF = {}
for _mode in _TIFF_MODES:
    for _name, _kw in (("lzw", dict(compression="tiff_lzw")), ("adobe_deflate", dict(compression="tiff_adobe_deflate")),
                       ("deflate", dict(compression="tiff_deflate")), ("packbits", dict(compression="packbits")),
                       ("lzw_predictor2", dict(compression="tiff_lzw", tiffinfo={317: 2})),
                       ("deflate_predictor2", dict(compression="tiff_adobe_deflate", tiffinfo={317: 2})),
                       ("bigtiff", dict(big_tiff=True)), ("bigtiff_lzw", dict(compression="tiff_lzw", big_tiff=True))):
        if _mode == "1" and "predictor" in _name:
            continue  # libtiff refuses the predictor on 1-bit samples
        TIFF[f"pil_{_mode}_{_name}"] = lambda m=_mode, kw=_kw: _pil_tiff(m, **kw)
_G16 = RNG.integers(0, 65536, (37, 45, 1), dtype=np.uint16)
_F32 = RNG.normal(size=(37, 45, 1)).astype(np.float32)
_I16 = RNG.integers(-3000, 3000, (37, 45, 1)).astype(np.int16)
for _comp, _cname in ((1, "raw"), (5, "lzw"), (8, "deflate")):
    for _layout, _kw in (("tiles", dict(tile=(16, 32))), ("planar", dict(planar=True, rows_per_strip=7)),
                         ("planar_tiles", dict(planar=True, tile=(32, 16))), ("strips", dict(rows_per_strip=5))):
        for _pred in ((1, 2) if _comp != 1 else (1,)):
            for _be in (False, True):
                TIFF[f"rgb_{_cname}_{_layout}_pred{_pred}_{'mm' if _be else 'ii'}"] = (
                    lambda c=_comp, kw=_kw, p=_pred, be=_be: tiff_bytes(RGB, 2, c, p, big_endian=be, **kw))
    TIFF[f"grey16_{_cname}_mm_tiles"] = lambda c=_comp: tiff_bytes(_G16, 1, c, tile=(16, 16), big_endian=True)
    TIFF[f"int16_{_cname}_mm"] = lambda c=_comp: tiff_bytes(_I16, 1, c, big_endian=True, sample_format=2)
    TIFF[f"float_{_cname}_mm"] = lambda c=_comp: tiff_bytes(_F32, 1, c, big_endian=True, sample_format=3)
    TIFF[f"bigtiff_rgb_{_cname}_tiles"] = lambda c=_comp: tiff_bytes(RGB, 2, c, 2 if c != 1 else 1, tile=(16, 16), big=True)
    for _depth in (1, 2, 4):
        for _ph in (0, 1, 3):
            TIFF[f"sub{_depth}bit_photometric{_ph}_{_cname}"] = (
                lambda c=_comp, d=_depth, ph=_ph: tiff_bytes(
                    RNG.integers(0, 1 << d, (13, 19, 1)).astype(np.uint8), ph, c, depth=d, palette=ph == 3,
                    rows_per_strip=4))
    TIFF[f"grey12_{_cname}"] = lambda c=_comp: tiff_bytes(
        RNG.integers(0, 4096, (13, 19, 1)).astype(np.uint16), 1, c, depth=12, rows_per_strip=4)
for _comp, _cname in ((5, "lzw"), (8, "deflate")):
    for _be in (False, True):
        TIFF[f"float_predictor3_{_cname}_{'mm' if _be else 'ii'}"] = (
            lambda c=_comp, be=_be: tiff_bytes(_F32, 1, c, 3, big_endian=be, sample_format=3, rows_per_strip=4))
    TIFF[f"float_predictor3_{_cname}_tiles"] = lambda c=_comp: tiff_bytes(_F32, 1, c, 3, tile=(16, 16), sample_format=3)
    TIFF[f"int32_predictor2_{_cname}"] = lambda c=_comp: tiff_bytes(
        RNG.integers(-2**31, 2**31, (37, 45, 1), dtype=np.int32), 1, c, 2, sample_format=2)
    TIFF[f"rgb16_predictor2_{_cname}"] = lambda c=_comp: tiff_bytes(
        RNG.integers(0, 65536, (37, 45, 3), dtype=np.uint16), 2, c, 2)
    TIFF[f"cmyk16_{_cname}"] = lambda c=_comp: tiff_bytes(RNG.integers(0, 65536, (37, 45, 4), dtype=np.uint16), 5, c)
    TIFF[f"rgba_premultiplied_{_cname}"] = lambda c=_comp: tiff_bytes(
        np.dstack([RGB // 2, RGB[..., :1] // 2 + RGB[..., 1:2] // 2]), 2, c, extra=(1,))
    TIFF[f"rgbx_{_cname}"] = lambda c=_comp: tiff_bytes(np.dstack([RGB, RGB[..., :2]]), 2, c, extra=(0, 0))
    TIFF[f"palette_alpha_{_cname}"] = lambda c=_comp: tiff_bytes(RGB[..., :2], 3, c, extra=(2,), palette=True)
    TIFF[f"white_is_zero_{_cname}"] = lambda c=_comp: tiff_bytes(RGB[..., :1], 0, c, 2)

CASES = {**{f"jpeg_{k}": v for k, v in JPEG.items()}, **{f"png_{k}": v for k, v in PNG.items()},
         **{f"tiff_{k}": v for k, v in TIFF.items()}}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Every case's file, written once: name -> path."""
    root = tmp_path_factory.mktemp("formats")
    out = {}
    for name, make in CASES.items():
        path = root / f"{name}.{name.split('_')[0].replace('jpeg', 'jpg').replace('tiff', 'tif')}"
        path.write_bytes(make())
        out[name] = str(path)
    return out


def _pil_array(path):
    with Image.open(path) as im:
        return np.asarray(im)


@pytest.mark.parametrize("name", sorted(CASES))
def test_decodes_as_pil(files, name):
    ref = _pil_array(files[name])
    got = read_image(files[name])
    assert got.dtype == ref.dtype.newbyteorder("=") and got.shape == ref.shape, (got.dtype, got.shape, ref.dtype,
                                                                                 ref.shape)
    if got.dtype.kind == "f":  # NaNs among byte-swapped floats: compare bits
        got, ref = got.view(f"u{got.itemsize}"), ref.astype(got.dtype).view(f"u{got.itemsize}")
    np.testing.assert_array_equal(got, ref)


def test_the_committed_progressive_frame_is_its_baseline_twin():
    """chip_smoke.py phase 16's twins: the same pixels through PIL and the port."""
    prog, base = (os.path.join(DATA, f"frame_{k}.jpg") for k in ("progressive", "baseline"))
    assert os.path.getsize(prog) < 100_000 and os.path.getsize(base) < 100_000
    assert b"\xff\xc2" in open(prog, "rb").read() and b"\xff\xc2" not in open(base, "rb").read()
    np.testing.assert_array_equal(read_image(prog), read_image(base))
    np.testing.assert_array_equal(read_image(prog), _pil_array(base))
    assert read_image(prog).shape == (960, 1280, 3)


@pytest.mark.parametrize("kind", ["progressive", "progressive_cmyk"])
def test_progressive_with_coefficients_left_unrefined_raises(tmp_path, kind):
    """A progressive file whose last scan is cut (coefficients 1-63 of one
    component left one bit short): libjpeg-turbo block-smooths it, which the
    port does not, so it raises naming the file; PIL reads it."""
    full = _pil(_image((40, 50), 24, 4 if "cmyk" in kind else 3), "JPEG", "CMYK" if "cmyk" in kind else None,
                quality=90, progressive=True)
    path = tmp_path / f"{kind}_cut.jpg"
    path.write_bytes(_without_scan(full, -1))
    assert _pil_array(str(path)).shape[:2] == (40, 50)
    with pytest.raises(NotImplementedError, match=f"{kind}_cut.jpg"):
        read_image(str(path))


def _refused(kind):
    rgb = _image((40, 50), 25)
    baseline = _pil(rgb, "JPEG", quality=90)
    sof = baseline.index(b"\xff\xc0")
    return {
        "jpeg_arithmetic.jpg": lambda: baseline[: sof + 1] + b"\xc9" + baseline[sof + 2 :],
        "jpeg_12bit.jpg": lambda: baseline[: sof + 4] + b"\x0c" + baseline[sof + 5 :],
        "jpeg_lossless.jpg": lambda: baseline[: sof + 1] + b"\xc3" + baseline[sof + 2 :],
        "jpeg_hierarchical.jpg": lambda: baseline[: sof + 1] + b"\xc5" + baseline[sof + 2 :],
        # Y 3x2, Cb 2x1: a ratio of 3 / 2, which libjpeg cannot upsample either
        "jpeg_fractional_factors.jpg": lambda: baseline[: sof + 11] + b"\x32" + baseline[sof + 12 : sof + 14]
        + b"\x21" + baseline[sof + 15 :],
        "tiff_jpeg.tif": lambda: _pil_bytes_tiff(rgb, compression="jpeg"),
        "tiff_float64.tif": lambda: tiff_bytes(RNG.normal(size=(5, 6, 1)), 1, sample_format=3),
        "tiff_lab.tif": lambda: tiff_bytes(rgb, 8),
        "bmp.bmp": lambda: _pil(rgb, "BMP"),
        "gif.gif": lambda: _pil(rgb[..., 0], "GIF"),
        "webp.webp": lambda: _pil(rgb, "WEBP", lossless=True),
    }[kind]()


def _pil_bytes_tiff(arr, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "TIFF", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("kind", ["jpeg_arithmetic.jpg", "jpeg_12bit.jpg", "jpeg_lossless.jpg", "jpeg_hierarchical.jpg",
                                  "jpeg_fractional_factors.jpg", "tiff_jpeg.tif", "tiff_float64.tif", "tiff_lab.tif",
                                  "bmp.bmp", "gif.gif", "webp.webp"])
def test_variants_left_out_raise_naming_the_file(tmp_path, kind):
    path = tmp_path / kind
    path.write_bytes(_refused(kind))
    with pytest.raises(NotImplementedError, match=kind.replace(".", r"\.")):
        read_image(str(path))


def test_unknown_bytes_raise_value_error():
    with pytest.raises(ValueError, match="blob.bin"):
        decode_image(b"\x00\x01not an image", "blob.bin")


@pytest.fixture(scope="module")
def format_tree(tmp_path_factory):
    """tests/torch_bop_tree.py's tree with each frame rewritten in another
    new variant: an interlaced PNG, an LZW TIFF with predictor 2 (RGB, under
    ``gray/``), a progressive JPEG (PIL, q95: lossy, decoded alike)."""
    root = str(tmp_path_factory.mktemp("bop_formats"))
    tree = write_bop_tree(root, n_views=6)
    test_dir = os.path.join(tree["data_dir"], "fakeds", "test")
    frames = sorted((scene, name) for scene in os.listdir(test_dir)
                    for name in os.listdir(os.path.join(test_dir, scene, "rgb")))
    for k, (scene, name) in enumerate(frames):
        src = os.path.join(test_dir, scene, "rgb", name)
        arr = _pil_array(src)
        arr = arr.reshape(*arr.shape[:2], -1)
        os.remove(src)
        stem = name.split(".")[0]
        if k % 3 == 0:
            blob, rel = png_bytes(arr, {1: 0, 3: 2, 4: 6}[arr.shape[2]], 8, interlace=True), f"rgb/{stem}.png"
        elif k % 3 == 1:
            blob, rel = tiff_bytes(arr, 2 if arr.shape[2] == 3 else 1, 5, 2, rows_per_strip=16), f"gray/{stem}.tif"
        else:
            blob, rel = _pil(arr.squeeze(), "JPEG", quality=95, progressive=True), f"rgb/{stem}.jpg"
        os.makedirs(os.path.join(test_dir, scene, os.path.dirname(rel)), exist_ok=True)
        with open(os.path.join(test_dir, scene, rel), "wb") as f:
            f.write(blob)
    for scene in os.listdir(test_dir):
        if not os.listdir(os.path.join(test_dir, scene, "rgb")):
            shutil.rmtree(os.path.join(test_dir, scene, "rgb"))
    return tree, len(frames)


def test_the_bop_loader_reads_the_new_formats_as_the_jax_one(format_tree):
    """Frames, K and every instance's crop (``load_image``) bitwise the JAX
    loader's, which decodes through PIL."""
    tree, n = format_tree
    args = (tree["data_dir"], "fakeds", tree["det_path"])
    got, ref = bop.BOPTestDataset(*args, n_template_view=6), jbop.BOPTestDataset(*args, n_template_view=6)
    assert got.keys == ref.keys and len(got) == n == 3
    for i in range(len(got)):
        rgb, K = got.load_raw(i)
        jrgb, jK = ref.load_raw(i)
        assert rgb.dtype == jrgb.dtype == np.uint8
        np.testing.assert_array_equal(rgb, jrgb)
        np.testing.assert_array_equal(K, jK)
        a, b = got.load_image(i), ref.load_image(i)
        assert vars(got.image_meta(i)) == vars(ref.image_meta(i))
        assert len(a.instances) == len(b.instances) > 0
        for x, y in zip(a.instances, b.instances):
            for k in ("obj_id", "score"):
                assert getattr(x, k) == getattr(y, k)
            for k in ("rgb", "mask", "M", "K", "pts2d"):
                np.testing.assert_array_equal(getattr(x, k), getattr(y, k), err_msg=k)
