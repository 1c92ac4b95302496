"""The port's JPEG decoder and encoder (picopose_tpu_torch/data/jpeg.py)
against PIL, which the JAX package decodes with (picopose_tpu/data/bop.py::_load_im)
and whose libjpeg-turbo encodes the JAX tool's frames (imageio q95).

Files are written here with PIL, imageio and cv2 from seeded numpy images,
in the forms the data uses (q95 4:2:0 as tools/synthetic_world.py writes
MegaPose frames, imageio's default quality) and the forms the decoder
reads besides (4:4:4, 4:2:2, 4:4:0, grey, restart intervals, Adobe RGB,
optimised Huffman tables, comments, sizes that are not multiples of 16;
progressive and 4:1:1 files, which it once refused; the other new
variants, and those still refused, are in tests/test_torch_formats.py).
Tolerance: bitwise equal to ``np.asarray(PIL.Image.open(path))``.  The
encoder's bytes equal PIL's at its defaults for the same quality, so they
decode, by PIL and by the port, to the arrays of PIL's own
encode-then-decode.
"""

import os
import re

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from picopose_tpu_torch.data.jpeg import encode_jpeg, read_image, read_jpeg, write_jpeg


def _image(hw, seed=0, grey=False):
    """Smooth colour waves plus noise: many non-zero coefficients."""
    rng = np.random.default_rng(seed)
    H, W = hw
    yy, xx = np.mgrid[:H, :W]
    img = np.stack([128 + 90 * np.sin(xx / (5 + c) + c) * np.cos(yy / (9 - c)) for c in range(3)], -1)
    img = np.clip(img + rng.normal(0, 18, (H, W, 3)), 0, 255).astype(np.uint8)
    return img[..., 0] if grey else img


def _pil(path, arr, **kw):
    Image.fromarray(arr).save(path, "JPEG", **kw)


def _cv2(path, arr, *params):
    assert cv2.imwrite(path, arr, list(params))


CASES = {
    # name: (size, writer)
    "q95_420_imageio_480x640": ((480, 640), lambda p, a: imageio.imwrite(p, a, quality=95)),
    "imageio_default_quality": ((120, 200), lambda p, a: imageio.imwrite(p, a, format="jpg")),
    "q95_420_17x33": ((17, 33), lambda p, a: _pil(p, a, quality=95)),
    "q75_444": ((90, 130), lambda p, a: _pil(p, a, quality=75, subsampling=0)),
    "q75_444_17x33": ((17, 33), lambda p, a: _pil(p, a, quality=75, subsampling=0)),
    "q75_422": ((90, 130), lambda p, a: _pil(p, a, quality=75, subsampling=1)),
    "q75_422_33x17": ((33, 17), lambda p, a: _pil(p, a, quality=75, subsampling=1)),
    "q90_440": ((61, 47), lambda p, a: _cv2(p, a, cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440)),
    "restart_every_3_mcus": ((100, 130), lambda p, a: _pil(p, a, quality=90, restart_marker_blocks=3)),
    "restart_every_row": ((100, 130), lambda p, a: _pil(p, a, quality=90, restart_marker_rows=1)),
    "restart_cv2_444": ((50, 70), lambda p, a: _cv2(p, a, cv2.IMWRITE_JPEG_RST_INTERVAL, 2,
                                                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)),
    "adobe_rgb": ((40, 50), lambda p, a: _pil(p, a, quality=90, keep_rgb=True, subsampling=0)),
    "optimized_tables_and_comment": ((40, 50), lambda p, a: _pil(p, a, quality=90, optimize=True, comment=b"x")),
    "three_by_two": ((3, 2), lambda p, a: _pil(p, a, quality=90)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_decodes_as_pil(tmp_path, name):
    hw, write = CASES[name]
    path = str(tmp_path / f"{name}.jpg")
    write(path, _image(hw, seed=len(name)))
    got = read_jpeg(path)
    ref = np.asarray(Image.open(path))
    assert got.dtype == np.uint8 and got.shape == ref.shape == (*hw, 3)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("hw", [(45, 61), (16, 16)])
def test_greyscale_decodes_as_pil(tmp_path, hw):
    path = str(tmp_path / "grey.jpg")
    _pil(path, _image(hw, grey=True), quality=90)
    ref = np.asarray(Image.open(path))
    assert ref.shape == hw
    np.testing.assert_array_equal(read_jpeg(path), ref)


def test_greyscale_with_restarts(tmp_path):
    path = str(tmp_path / "grey_rst.jpg")
    _cv2(path, _image((40, 70), grey=True), cv2.IMWRITE_JPEG_RST_INTERVAL, 5)
    np.testing.assert_array_equal(read_jpeg(path), np.asarray(Image.open(path)))


@pytest.mark.parametrize("kind", ["progressive", "411"])
def test_unsupported_files_raise_naming_them(tmp_path, kind):
    """The two kinds this test once saw refused, progressive and 4:1:1
    files, now decode as PIL decodes them; an arithmetic-coded frame (SOF9)
    of each still raises, naming the file."""
    path = str(tmp_path / f"{kind}.jpg")
    if kind == "progressive":
        _pil(path, _image((40, 50)), quality=90, progressive=True)
    else:
        _cv2(path, _image((40, 50)), cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411)
    np.testing.assert_array_equal(read_jpeg(path), np.asarray(Image.open(path)))
    data = open(path, "rb").read()
    sof = re.search(rb"\xff[\xc0\xc2]", data).start()
    arith = str(tmp_path / f"{kind}_arithmetic.jpg")
    open(arith, "wb").write(data[: sof + 1] + b"\xc9" + data[sof + 2 :])
    with pytest.raises(NotImplementedError, match=f"{kind}_arithmetic.jpg"):
        read_jpeg(arith)


@pytest.mark.parametrize("cut", ["header", "scan", "eoi"])
def test_truncated_files_raise_value_error_naming_them(tmp_path, cut):
    full = str(tmp_path / "full.jpg")
    _pil(full, _image((64, 80)), quality=95)
    data = open(full, "rb").read()
    keep = {"header": 300, "scan": len(data) // 2, "eoi": len(data) - 2}[cut]
    path = str(tmp_path / f"cut_{cut}.jpg")
    open(path, "wb").write(data[:keep])
    with pytest.raises(ValueError, match=f"cut_{cut}.jpg"):
        read_jpeg(path)
    with pytest.raises(OSError):  # PIL refuses them too
        Image.open(path).load()


def test_corrupt_scan_raises_value_error(tmp_path):
    full = str(tmp_path / "full.jpg")
    _pil(full, _image((64, 80)), quality=95)
    data = bytearray(open(full, "rb").read())
    mid = len(data) // 2
    data[mid : mid + 64] = bytes(range(64))
    path = str(tmp_path / "corrupt.jpg")
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="corrupt.jpg"):
        read_jpeg(path)


def test_read_image_dispatches_on_the_signature(tmp_path):
    rgb = _image((20, 30))
    Image.fromarray(rgb).save(tmp_path / "a.png")
    _pil(str(tmp_path / "b.jpg"), rgb, quality=90)
    os.rename(tmp_path / "b.jpg", tmp_path / "b.png")  # the name does not decide
    np.testing.assert_array_equal(read_image(str(tmp_path / "a.png")), rgb)
    np.testing.assert_array_equal(read_image(str(tmp_path / "b.png")), np.asarray(Image.open(tmp_path / "b.png")))
    Image.fromarray(rgb[..., 0]).save(tmp_path / "c.tif")
    np.testing.assert_array_equal(read_image(str(tmp_path / "c.tif")), rgb[..., 0])
    Image.fromarray(rgb[..., 0]).save(tmp_path / "e.tif", compression="tiff_lzw")
    np.testing.assert_array_equal(read_image(str(tmp_path / "e.tif")), rgb[..., 0])
    Image.fromarray(rgb).save(tmp_path / "f.tif", compression="jpeg")
    with pytest.raises(NotImplementedError, match="f.tif"):
        read_image(str(tmp_path / "f.tif"))
    (tmp_path / "d.bin").write_bytes(b"GIF89a......")
    with pytest.raises(NotImplementedError, match="d.bin"):  # PIL's GIF family, not read
        read_image(str(tmp_path / "d.bin"))
    (tmp_path / "g.bin").write_bytes(b"\x00\x01......")
    with pytest.raises(ValueError, match="g.bin"):
        read_image(str(tmp_path / "g.bin"))


def _rendered_frame(tmp_path):
    """A 480 x 640 frame of the synthetic world's textured block and L shape."""
    from picopose_tpu_torch import synthetic_world as world

    rng = np.random.default_rng(3)
    objs = world.build_objects(str(tmp_path), ["tex", "lshape"], 60.0)
    rgb, _, _, _ = world.render_composite(objs, [world.random_poses(1, rng, o.z0)[0] for o in objs])
    assert (rgb > 0).mean() > 0.02
    return rgb


ENCODE_CASES = {  # name: (height, width) or "rendered"
    "480x640": (480, 640), "17x33": (17, 33), "45x61": (45, 61), "8x8": (8, 8), "rendered": "rendered",
}


@pytest.mark.parametrize("quality", [95, 75])
@pytest.mark.parametrize("name", sorted(ENCODE_CASES))
def test_encoder_matches_pil(tmp_path, name, quality):
    hw = ENCODE_CASES[name]
    rgb = _rendered_frame(tmp_path) if hw == "rendered" else _image(hw, seed=len(name))
    ref = str(tmp_path / "pil.jpg")
    _pil(ref, rgb, quality=quality)
    ours = str(tmp_path / "port.jpg")
    write_jpeg(ours, rgb, quality=quality)
    with open(ref, "rb") as f:
        assert encode_jpeg(rgb, quality) == f.read()
    want = np.asarray(Image.open(ref))
    np.testing.assert_array_equal(np.asarray(Image.open(ours)), want)
    np.testing.assert_array_equal(read_jpeg(ours), want)


def test_encoder_matches_imageio_q95(tmp_path):
    """tools/synthetic_world.py writes its frames with imageio at q95."""
    rgb = _image((37, 50), seed=5)
    path = str(tmp_path / "a.jpg")
    imageio.imwrite(path, rgb, quality=95)
    with open(path, "rb") as f:
        assert encode_jpeg(rgb) == f.read()


def test_encoder_refuses_other_arrays():
    for bad in (np.zeros((4, 4), np.uint8), np.zeros((4, 4, 4), np.uint8), np.zeros((4, 4, 3), np.float32)):
        with pytest.raises(ValueError, match="cannot encode"):
            encode_jpeg(bad)
