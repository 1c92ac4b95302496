"""The port's baseline JPEG decoder (picopose_tpu_torch/data/jpeg.py) against
PIL, which the JAX package decodes with (picopose_tpu/data/bop.py::_load_im).

Files are written here with PIL, imageio and cv2 from seeded numpy images,
in the forms the data uses (q95 4:2:0 as tools/synthetic_world.py writes
MegaPose frames, imageio's default quality) and the forms the decoder
reads besides (4:4:4, 4:2:2, 4:4:0, grey, restart intervals, Adobe RGB,
optimised Huffman tables, comments, sizes that are not multiples of 16).
Tolerance: bitwise equal to ``np.asarray(PIL.Image.open(path))``.
"""

import os

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from picopose_tpu_torch.data.jpeg import read_image, read_jpeg


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
    path = str(tmp_path / f"{kind}.jpg")
    if kind == "progressive":
        _pil(path, _image((40, 50)), quality=90, progressive=True)
    else:
        _cv2(path, _image((40, 50)), cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411)
    with pytest.raises(NotImplementedError, match=f"{kind}.jpg"):
        read_jpeg(path)


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
    with pytest.raises(NotImplementedError, match="c.tif"):
        read_image(str(tmp_path / "c.tif"))
    (tmp_path / "d.bin").write_bytes(b"GIF89a......")
    with pytest.raises(ValueError, match="d.bin"):
        read_image(str(tmp_path / "d.bin"))
