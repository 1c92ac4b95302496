"""The port's host library (picopose_tpu_torch/native/) against the JAX
package's native fast path, on the CPU.

The build: the library's name follows its sources and flags, two
processes building it at once both load a whole library, and a failed
build or a missing compiler raises.  The five fast-path entry points
(``rle_decode_counts`` through ``rle_to_mask``, ``rle_counts_to_mask``,
``mask_bbox``, ``crop_resize_normalize``, ``crop_mask_nearest``) are
bitwise equal to ``picopose_tpu.native.fastpath`` on seeded RLEs
(compressed and raw counts), masks and frames: the two libraries are the
same source built with the same compiler and flags on the same machine.
data/rle.py and data/crops.py take the C++ path by default and the numpy
path under ``PICOPOSE_NO_FASTPATH=1`` (``CALLS`` shows which ran); the
C++ rgb crop is within 5e-4 of the numpy one, as the JAX package holds
its C++ crop to cv2 (tests/test_native.py).
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from picopose_tpu.data.crops import crop_and_normalize_rgb_py as jax_crop_py
from picopose_tpu.data.rle import rle_to_mask_py as jax_rle_py
from picopose_tpu.native import fastpath as jfast
from picopose_tpu_torch import native
from picopose_tpu_torch.data import crops, rle
from picopose_tpu_torch.native import fastpath

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 96, 128


def rle_raw(mask):
    flat = mask.flatten(order="F").astype(np.int8)
    edges = np.flatnonzero(np.diff(np.r_[0, flat, 1 - flat[-1]]))
    return {"size": list(mask.shape), "counts": np.diff(np.r_[0, edges]).tolist()}


def rle_compressed(mask):
    """COCO's compressed counts string (the inverse of the LEB128 decode)."""
    counts = rle_raw(mask)["counts"]
    out = []
    for i, x in enumerate(counts):
        x -= counts[i - 2] if i > 2 else 0
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = x != -1 if c & 0x10 else x != 0
            out.append(chr((c | 0x20 if more else c) + 48))
    return {"size": list(mask.shape), "counts": "".join(out)}


def masks():
    """Seeded masks: noise at three densities, an ellipse, a corner block,
    an empty and a full one."""
    rng = np.random.default_rng(7)
    out = [(rng.random((H, W)) > p).astype(np.uint8) for p in (0.2, 0.5, 0.95)]
    yy, xx = np.mgrid[:H, :W]
    out.append((((yy - 40) / 25.0) ** 2 + ((xx - 70) / 35.0) ** 2 <= 1).astype(np.uint8))
    block = np.zeros((H, W), np.uint8)
    block[H - 9:, W - 13:] = 1
    out += [block, np.zeros((H, W), np.uint8), np.ones((H, W), np.uint8)]
    return out


@pytest.fixture(scope="module")
def frame():
    return np.random.default_rng(3).integers(0, 256, size=(H, W, 3), dtype=np.uint8)


# (y1, y2, x1, x2): downscaled, upscaled, the whole frame's height, at the
# bottom-right border, a 1-pixel-wide box
BOXES = [(10, 74, 20, 84), (30, 50, 40, 60), (0, 96, 16, 112), (60, 96, 92, 128), (5, 45, 50, 51)]


@pytest.mark.parametrize("encode", [rle_raw, rle_compressed])
def test_rle_is_bitwise_the_jax_native_decode(encode):
    for mask in masks():
        r = encode(mask)
        got = fastpath.rle_to_mask(r)
        assert got.dtype == np.uint8 and got.shape == (H, W)
        np.testing.assert_array_equal(got, jfast.rle_to_mask(r))
        np.testing.assert_array_equal(got, mask)
        np.testing.assert_array_equal(got, jax_rle_py(r))
    # bytes counts, and runs that overshoot the frame are cut as in C++
    r = rle_compressed(masks()[1])
    np.testing.assert_array_equal(fastpath.rle_to_mask({**r, "counts": r["counts"].encode()}),
                                  jfast.rle_to_mask(r))
    over = {"size": [4, 5], "counts": [3, 30]}
    np.testing.assert_array_equal(fastpath.rle_to_mask(over), jfast.rle_to_mask(over))


def test_mask_bbox_is_the_jax_native_one():
    for mask in masks():
        got = fastpath.mask_bbox(mask)
        assert got == jfast.mask_bbox(mask)
        if mask.any():
            ys, xs = np.nonzero(mask)
            assert got == (ys.min(), ys.max() + 1, xs.min(), xs.max() + 1)
        else:
            assert got is None


@pytest.mark.parametrize("bgr_flip", [True, False])
@pytest.mark.parametrize("mask_rgb", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_crop_resize_normalize_is_the_jax_native_one(frame, bgr_flip, mask_rgb, with_mask):
    mask = masks()[1] if with_mask else None
    for box in BOXES:
        for out in (32, 56, 224):
            kw = dict(mask=mask, mask_rgb=mask_rgb, bgr_flip=bgr_flip)
            got = fastpath.crop_resize_normalize(frame, box, out, **kw)
            assert got.dtype == np.float32 and got.shape == (out, out, 3)
            np.testing.assert_array_equal(got, jfast.crop_resize_normalize(frame, box, out, **kw))


def test_crop_mask_nearest_is_the_jax_native_one():
    """Bitwise the JAX package's; it is not always cv2's INTER_NEAREST
    (data/crops.py::crop_mask): its source index is floor(dst * scale) in
    float32, where cv2 computes the scale's inverse in float64, and the two
    part at some upscales (up to 252 of 50176 pixels at 36 -> 224 here).  No
    loader of either package dispatches to it."""
    for mask in masks():
        for box in BOXES:
            for out in (32, 224):
                got = fastpath.crop_mask_nearest(mask, box, out)
                np.testing.assert_array_equal(got, jfast.crop_mask_nearest(mask, box, out))
    np.testing.assert_array_equal(fastpath.crop_mask_nearest(masks()[0], BOXES[0], 56),
                                  crops.crop_mask(masks()[0], BOXES[0], 56))


@pytest.fixture
def no_fastpath(monkeypatch):
    monkeypatch.setenv("PICOPOSE_NO_FASTPATH", "1")


def test_dispatch_takes_cpp_by_default(frame, monkeypatch):
    monkeypatch.delenv("PICOPOSE_NO_FASTPATH", raising=False)
    assert fastpath.accelerated()
    mask = masks()[3]
    native.reset_calls()
    got = crops.crop_and_normalize_rgb(frame, BOXES[0], 56, mask, True)
    np.testing.assert_array_equal(got, jfast.crop_resize_normalize(frame, BOXES[0], 56, mask=mask, mask_rgb=True))
    np.testing.assert_array_equal(rle.rle_to_mask(rle_compressed(mask)), mask)
    np.testing.assert_array_equal(rle.rle_to_mask(rle_raw(mask)), mask)
    assert native.CALLS == {"crop_resize_normalize": 1, "rle_decode_counts": 1, "rle_counts_to_mask": 2}
    # a float frame takes the numpy path, as in the JAX package
    native.reset_calls()
    crops.crop_and_normalize_rgb(frame.astype(np.float32), BOXES[0], 56)
    assert not native.CALLS


def test_dispatch_takes_numpy_under_the_switch(frame, no_fastpath):
    assert not fastpath.accelerated()
    mask = masks()[3]
    native.reset_calls()
    for mask_rgb in (False, True):
        got = crops.crop_and_normalize_rgb(frame, BOXES[0], 56, mask, mask_rgb)
        np.testing.assert_array_equal(got, crops.crop_and_normalize_rgb_py(frame, BOXES[0], 56, mask, mask_rgb))
        # the bound tests/test_torch_serve.py holds the port's numpy crop to
        # cv2's with (both resize in float64; measured 1.4e-14 there)
        np.testing.assert_allclose(got, jax_crop_py(frame, BOXES[0], 56, mask, mask_rgb), atol=2e-4, rtol=0)
    np.testing.assert_array_equal(rle.rle_to_mask(rle_compressed(mask)), mask)
    assert not native.CALLS


@pytest.mark.parametrize("mask_rgb", [False, True])
def test_cpp_crop_within_5e_4_of_numpy(frame, mask_rgb):
    """The C++ crop computes in float32, the numpy one in float64 (measured
    max 1.6e-5 here); the JAX package's bound for its C++ crop is 5e-4."""
    mask = masks()[0]
    for box in BOXES:
        for out in (32, 56, 224):
            got = fastpath.crop_resize_normalize(frame, box, out, mask=mask, mask_rgb=mask_rgb)
            ref = crops.crop_and_normalize_rgb_py(frame, box, out, mask, mask_rgb)
            np.testing.assert_allclose(got, ref, atol=5e-4, rtol=0)


# ---- the build ---------------------------------------------------------------


def _copy_sources(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(native.CSRC_DIR, csrc)
    return str(csrc), str(tmp_path / "build")


def test_library_name_follows_sources_and_flags(tmp_path, monkeypatch):
    csrc, build = _copy_sources(tmp_path)
    monkeypatch.setattr(native, "CSRC_DIR", csrc)
    monkeypatch.setattr(native, "BUILD_DIR", build)
    first = native.library_path()
    assert os.path.dirname(first) == build and os.path.basename(first).startswith("libpicopose_host-")
    assert native.library_path() == first
    with open(os.path.join(csrc, "fastpath.cpp"), "a") as f:
        f.write("\n// changed\n")
    second = native.library_path()
    assert second != first
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    assert native.library_path() not in (first, second)


BUILD_AND_CALL = """
import sys
import numpy as np
from picopose_tpu_torch import native
native.CSRC_DIR, native.BUILD_DIR = sys.argv[1], sys.argv[2]
from picopose_tpu_torch.native import fastpath
m = np.zeros((5, 7), np.uint8); m[1:3, 2:6] = 1
print(native.library_path(), fastpath.mask_bbox(m))
"""


def test_two_processes_building_at_once_both_load_it(tmp_path):
    csrc, build = _copy_sources(tmp_path)
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_AND_CALL, csrc, build], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    lines = {out.strip() for out, _ in outs}
    assert len(lines) == 1 and lines.pop().endswith("(1, 3, 2, 6)")
    assert [n for n in os.listdir(build) if n.endswith(".tmp")] == []


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    csrc, build = _copy_sources(tmp_path)
    with open(os.path.join(csrc, "broken.cpp"), "w") as f:
        f.write("int broken( { return 0; }\n")
    monkeypatch.setattr(native, "CSRC_DIR", csrc)
    monkeypatch.setattr(native, "BUILD_DIR", build)
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match=r"(?s)broken.cpp.*error"):
        native.load_library()
    assert not os.path.exists(native.library_path())
    # the switch is the only way to the numpy path: a failed build raises
    monkeypatch.delenv("PICOPOSE_NO_FASTPATH", raising=False)
    with pytest.raises(RuntimeError, match="host library build failed"):
        fastpath.accelerated()
    monkeypatch.setenv("PICOPOSE_NO_FASTPATH", "1")
    assert not fastpath.accelerated()


def test_missing_compiler_raises(tmp_path, monkeypatch):
    csrc, build = _copy_sources(tmp_path)
    monkeypatch.setattr(native, "CSRC_DIR", csrc)
    monkeypatch.setattr(native, "BUILD_DIR", build)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CXX", "no-such-compiler-here")
    with pytest.raises(RuntimeError, match="no-such-compiler-here.*not found"):
        native.load_library()


def test_available_is_the_jax_packages_answer():
    from picopose_tpu import native as jnative

    assert native.available() is True
    assert native.available() == jnative.available()


def test_available_is_false_without_a_compiler(tmp_path, monkeypatch):
    """As the JAX package's: a library that cannot be built is not available."""
    csrc, build = _copy_sources(tmp_path)
    monkeypatch.setattr(native, "CSRC_DIR", csrc)
    monkeypatch.setattr(native, "BUILD_DIR", build)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CXX", "no-such-compiler-here")
    assert native.available() is False


def test_importing_the_package_builds_nothing(tmp_path):
    code = ("import picopose_tpu_torch.native.fastpath, picopose_tpu_torch.native.renderer, "
            "picopose_tpu_torch.data.crops, picopose_tpu_torch.data.rle; "
            "from picopose_tpu_torch import native; print(native._lib)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "None"
