"""The port's TIFF reader (picopose_tpu_torch/data/tiff.py) against PIL,
and the port's BOP loader on ITODD-style ``gray/*.tif`` frames against the
JAX loader, on the CPU.

Files: PIL's uncompressed TIFFs (8-bit grey, 16-bit grey in both byte
orders, RGB; one strip and 19), and the port's ``encode_tiff`` in both byte
orders and with 1, 7 and all rows per strip, each read by PIL.  The
arrays equal PIL's (16-bit values as native ``uint16``; PIL gives
big-endian files a big-endian dtype).  The kinds the reader once refused
(compressed files, tiles, planar RGB, WhiteIsZero, signed samples,
predictors, 1-bit and RGBA files) read as PIL reads them; FillOrder 2 and
truncated files raise, naming the file (every other variant, read or
refused, is in tests/test_torch_formats.py).  No tolerance: every
comparison is exact.
"""

import io
import os
import shutil
import struct

import numpy as np
import pytest
from PIL import Image
from torch_bop_tree import write_bop_tree
from torch_image_files import tiff_bytes

from picopose_tpu.data import bop as jbop
from picopose_tpu_torch.data import bop
from picopose_tpu_torch.data import tiff
from picopose_tpu_torch.data.jpeg import read_image

SHAPE = (300, 257)


def arrays():
    rng = np.random.default_rng(0)
    return {
        "grey8": rng.integers(0, 256, SHAPE, dtype=np.uint8),
        "grey16": rng.integers(0, 65536, SHAPE, dtype=np.uint16),
        "rgb": rng.integers(0, 256, SHAPE + (3,), dtype=np.uint8),
    }


def _pil_bytes(im, **kw):
    buf = io.BytesIO()
    im.save(buf, format="TIFF", **kw)
    return buf.getvalue()


def _strips(buf):
    return len(tiff._ifd(buf, "x")[1][tiff.STRIP_OFFSETS])


@pytest.mark.parametrize("kind", ["grey8", "grey16", "grey16_big_endian", "rgb"])
def test_pil_uncompressed_files(tmp_path, kind):
    arr = arrays()[kind.removesuffix("_big_endian")]
    im = Image.fromarray(arr)
    if kind.endswith("big_endian"):
        im = Image.frombytes("I;16B", arr.shape[::-1], arr.astype(">u2").tobytes())
    for rows in (None, 16):
        buf = _pil_bytes(im, **({} if rows is None else {"tiffinfo": {tiff.ROWS_PER_STRIP: rows}}))
        assert buf[:2] == (b"MM" if kind.endswith("big_endian") else b"II")
        assert _strips(buf) == (1 if rows is None else 19)
        ref = np.asarray(Image.open(io.BytesIO(buf)))
        got = tiff.decode_tiff(buf)
        assert got.shape == ref.shape and got.dtype == ref.dtype.newbyteorder("=")
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, arr)
    path = tmp_path / "frame.tif"
    path.write_bytes(buf)
    np.testing.assert_array_equal(read_image(str(path)), arr)


@pytest.mark.parametrize("big_endian", [False, True])
@pytest.mark.parametrize("rows", [1, 7, None])
@pytest.mark.parametrize("kind", ["grey8", "grey16", "rgb"])
def test_encode_tiff_files_read_as_pil_reads_them(kind, big_endian, rows):
    arr = arrays()[kind][:41, :33]
    buf = tiff.encode_tiff(arr, big_endian=big_endian, rows_per_strip=rows)
    assert _strips(buf) == (41 if rows == 1 else 6 if rows == 7 else 1)
    ref = np.asarray(Image.open(io.BytesIO(buf)))
    got = tiff.decode_tiff(buf)
    assert got.shape == ref.shape and got.dtype == ref.dtype.newbyteorder("=")
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, arr)


def _with_tag(buf, tag, value=None, kind=3):
    """``buf`` with ``tag`` set to ``value`` (SHORT in place; a new LONG
    entry if absent)."""
    bo, tags = tiff._ifd(buf, "x")
    (pos,) = struct.unpack(bo + "I", buf[4:8])
    (n,) = struct.unpack(bo + "H", buf[pos:pos + 2])
    entries = [buf[pos + 2 + 12 * i: pos + 14 + 12 * i] for i in range(n)]
    entries = [e for e in entries if struct.unpack(bo + "H", e[:2])[0] != tag]
    if value is not None:
        field = struct.pack(bo + ("H" if kind == 3 else "I"), value).ljust(4, b"\x00")
        entries.append(struct.pack(bo + "HHI", tag, kind, 1) + field)
    entries.sort(key=lambda e: struct.unpack(bo + "H", e[:2])[0])
    ifd = struct.pack(bo + "H", len(entries)) + b"".join(entries) + struct.pack(bo + "I", 0)
    end = len(buf)
    return buf[:4] + struct.pack(bo + "I", end) + buf[8:] + ifd


@pytest.mark.parametrize("case", ["lzw", "packbits", "deflate", "tiled", "planar", "white_is_zero", "signed",
                                  "predictor", "bilevel", "rgba", "fill_order"])
def test_refused_kinds_raise_naming_file_and_tag(tmp_path, case):
    """FillOrder 2 still raises, naming the file and the tag; every other
    kind here was refused once and now reads as PIL reads it."""
    arr = arrays()["grey8"][:40, :40]
    plain = tiff.encode_tiff(arr)
    buf, tag = {
        "lzw": lambda: (_pil_bytes(Image.fromarray(arr), compression="tiff_lzw"), "Compression"),
        "packbits": lambda: (_pil_bytes(Image.fromarray(arr), compression="packbits"), "Compression"),
        "deflate": lambda: (_pil_bytes(Image.fromarray(arr), compression="tiff_adobe_deflate"), "Compression"),
        "tiled": lambda: (_with_tag(plain, tiff.TILE_WIDTH, 16), "TileWidth"),
        "planar": lambda: (_with_tag(tiff.encode_tiff(arrays()["rgb"][:8, :8]), tiff.PLANAR, 2),
                           "PlanarConfiguration"),
        "white_is_zero": lambda: (_with_tag(plain, tiff.PHOTOMETRIC, 0), "PhotometricInterpretation"),
        "signed": lambda: (_with_tag(plain, tiff.SAMPLE_FORMAT, 2), "SampleFormat"),
        "predictor": lambda: (_with_tag(plain, tiff.PREDICTOR, 2), "Predictor"),
        "bilevel": lambda: (_pil_bytes(Image.fromarray(arr > 100)), "BitsPerSample"),
        "rgba": lambda: (_pil_bytes(Image.fromarray(np.dstack([arr] * 4))), "SamplesPerPixel"),
        "fill_order": lambda: (_with_tag(plain, tiff.FILL_ORDER, 2), "FillOrder"),
    }[case]()
    path = tmp_path / f"{case}.tif"
    path.write_bytes(buf)
    if case == "planar":  # the tag on chunky strips: one strip for three planes, malformed
        with pytest.raises(ValueError, match=r"planar\.tif: TIFF with 1 of 3 strips"):
            read_image(str(path))
        path = tmp_path / "planar_strips.tif"  # a planar file
        path.write_bytes(tiff_bytes(arrays()["rgb"][:8, :8], 2, planar=True, rows_per_strip=3))
    if case != "fill_order":  # read since the reader took them on, as PIL reads them
        with Image.open(path) as im:
            ref = np.asarray(im)
        got = read_image(str(path))
        assert got.shape == ref.shape and got.dtype == ref.dtype.newbyteorder("="), (tag, got.dtype, ref.dtype)
        np.testing.assert_array_equal(got, ref)
        return
    with pytest.raises(NotImplementedError, match=rf"{case}\.tif: TIFF {tag}"):
        read_image(str(path))


def test_truncated_files_raise_value_error(tmp_path):
    buf = tiff.encode_tiff(arrays()["grey8"][:40, :40], rows_per_strip=8)
    for name, data in (("head.tif", buf[:6]), ("strips.tif", buf[:1000] + buf[1600:])):
        (tmp_path / name).write_bytes(data)
        with pytest.raises(ValueError, match=name):
            read_image(str(tmp_path / name))


@pytest.fixture(scope="module")
def grey_tree(tmp_path_factory):
    """tests/torch_bop_tree.py's tree with every frame moved to
    ``gray/<im>.tif`` as an uncompressed 8-bit grey TIFF (ITODD's form)."""
    root = str(tmp_path_factory.mktemp("tif"))
    tree = write_bop_tree(root, n_views=6)
    test_dir = os.path.join(tree["data_dir"], "fakeds", "test")
    for scene in os.listdir(test_dir):
        rgb_dir = os.path.join(test_dir, scene, "rgb")
        os.makedirs(os.path.join(test_dir, scene, "gray"))
        for name in os.listdir(rgb_dir):
            grey = Image.open(os.path.join(rgb_dir, name)).convert("L")
            grey.save(os.path.join(test_dir, scene, "gray", name.replace(".png", ".tif")), compression=None)
        shutil.rmtree(rgb_dir)
    return tree


def test_the_bop_loader_reads_tiff_frames_as_the_jax_one(grey_tree):
    """Frames, crops and ``load_image`` bitwise the JAX loader's (both take
    their C++ crops)."""
    args = (grey_tree["data_dir"], "fakeds", grey_tree["det_path"])
    got, ref = bop.BOPTestDataset(*args, n_template_view=6), jbop.BOPTestDataset(*args, n_template_view=6)
    assert got.keys == ref.keys and len(got) == 3
    for i in range(len(got)):
        rgb, K = got.load_raw(i)
        jrgb, jK = ref.load_raw(i)
        assert rgb.dtype == np.uint8 and rgb.ndim == 3 and rgb.shape[2] == 3
        np.testing.assert_array_equal(rgb, jrgb)
        np.testing.assert_array_equal(rgb[..., 0], rgb[..., 2])
        np.testing.assert_array_equal(K, jK)
        a, b = got.load_image(i), ref.load_image(i)
        assert len(a.instances) == len(b.instances) > 0
        for x, y in zip(a.instances, b.instances):
            for k in ("obj_id", "score"):
                assert getattr(x, k) == getattr(y, k)
            for k in ("rgb", "mask", "M", "K", "pts2d"):
                np.testing.assert_array_equal(getattr(x, k), getattr(y, k), err_msg=k)
