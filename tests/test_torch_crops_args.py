"""The crop arguments the port took over from the JAX package:
``size_ratio`` of ``mask_square_bbox`` / ``square_bbox`` and ``bgr_flip``
of the rgb crops, on the numpy, C++ and on-device (``preprocess_frame``)
routes, each against the JAX function of the same name.

Tolerances (as tests/test_torch_serve.py holds the default arguments):
boxes exact; the port's numpy crop within 2e-4 normalised units of
cv2's INTER_LINEAR (the JAX ``crop_and_normalize_rgb_py``); the C++ crop
bitwise the JAX package's (the same source, compiler and flags);
``preprocess_frame`` within 1e-5 of the JAX one at 64^2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picopose_tpu.data import crops as jcrops
from picopose_tpu.ops.preprocess import preprocess_frame as jax_preprocess_frame
from picopose_tpu_torch import native
from picopose_tpu_torch.data import crops
from picopose_tpu_torch.ops.preprocess import preprocess_frame, preprocess_frame_graphed
from picopose_tpu_torch.utils.graphs import GraphCache

H, W = 120, 160
# blobs (cy, cx, ry, rx): centred, at the top-left border, at the bottom-right border, thin, wide
BLOBS = [(60, 80, 25, 30), (8, 10, 12, 14), (112, 152, 18, 10), (60, 80, 40, 4), (60, 80, 10, 70)]
RATIOS = [0.8, 1.0, 1.3]


def blob(cy, cx, ry, rx):
    yy, xx = np.mgrid[:H, :W]
    return ((((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) <= 1.0).astype(np.uint8)


@pytest.fixture(scope="module")
def frame():
    return np.random.default_rng(12).integers(0, 256, size=(H, W, 3), dtype=np.uint8)


@pytest.mark.parametrize("size_ratio", RATIOS)
def test_square_boxes_take_the_size_ratio(size_ratio):
    for b in BLOBS:
        m = blob(*b)
        got = crops.mask_square_bbox(m, size_ratio)
        assert got == jcrops.mask_square_bbox(m, size_ratio), b
        assert all(type(v) is int for v in got)
    for box in [(10, 50, 20, 90), (0, 120, 0, 40), (100, 120, 150, 160), (30, 31, 40, 41)]:
        assert crops.square_bbox(box, (H, W), size_ratio) == jcrops.square_bbox(box, (H, W), size_ratio), box
    if size_ratio == 1.0:  # the default is the ratio the callers use
        assert crops.mask_square_bbox(blob(*BLOBS[0])) == crops.mask_square_bbox(blob(*BLOBS[0]), 1.0)


@pytest.mark.parametrize("mask_rgb", [False, True])
@pytest.mark.parametrize("bgr_flip", [False, True])
def test_numpy_crop_takes_bgr_flip(frame, bgr_flip, mask_rgb, monkeypatch):
    monkeypatch.setenv("PICOPOSE_NO_FASTPATH", "1")
    m = blob(*BLOBS[0])
    box = crops.mask_square_bbox(m, 1.3)
    native.reset_calls()
    got = crops.crop_and_normalize_rgb(frame, box, 56, m, mask_rgb, bgr_flip=bgr_flip)
    assert not native.CALLS
    ref = jcrops.crop_and_normalize_rgb_py(frame, box, 56, m, mask_rgb, bgr_flip=bgr_flip)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)
    # no flip of the frame is the flip of the frame reversed
    flipped = crops.crop_and_normalize_rgb_py(np.ascontiguousarray(frame[..., ::-1]), box, 56, m, mask_rgb,
                                              bgr_flip=not bgr_flip)
    np.testing.assert_array_equal(got, flipped)


@pytest.mark.parametrize("bgr_flip", [False, True])
def test_cpp_crop_takes_bgr_flip(frame, bgr_flip, monkeypatch):
    monkeypatch.delenv("PICOPOSE_NO_FASTPATH", raising=False)
    m = blob(*BLOBS[2])
    for size_ratio in RATIOS:
        box = crops.mask_square_bbox(m, size_ratio)
        native.reset_calls()
        got = crops.crop_and_normalize_rgb(frame, box, 64, m, True, bgr_flip=bgr_flip)
        assert native.CALLS == {"crop_resize_normalize": 1}
        np.testing.assert_array_equal(got, jcrops.crop_and_normalize_rgb(frame, box, 64, m, True, bgr_flip=bgr_flip))
        np.testing.assert_allclose(got, crops.crop_and_normalize_rgb_py(frame, box, 64, m, True, bgr_flip),
                                   atol=5e-4, rtol=0)


@pytest.mark.parametrize("bgr_flip", [False, True])
def test_preprocess_frame_takes_bgr_flip(frame, bgr_flip):
    masks = np.stack([blob(*b) for b in BLOBS])
    ref = jax_preprocess_frame(jnp.asarray(frame), jnp.asarray(masks), out=64, pts=16, bgr_flip=bgr_flip)
    got = preprocess_frame(torch.from_numpy(frame), torch.from_numpy(masks), out=64, pts=16, bgr_flip=bgr_flip)
    for k in ("real_rgb", "real_mask", "real_M", "real_pts2d"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-5, rtol=0, err_msg=k)
    other = preprocess_frame(torch.from_numpy(frame), torch.from_numpy(masks), out=64, pts=16,
                             bgr_flip=not bgr_flip)
    assert not torch.equal(got["real_rgb"], other["real_rgb"])
    assert torch.equal(got["real_M"], other["real_M"])


def test_bgr_flip_is_in_the_graph_key(frame, monkeypatch):
    """``preprocess_frame_graphed`` passes ``bgr_flip`` to the program and
    keys on it: a static argument, as ``jit``'s static_argnames."""
    graphs = GraphCache("cpu")
    statics = []
    real_run = graphs.run
    monkeypatch.setattr(graphs, "run", lambda name, fn, args, static=(), **kw: (
        statics.append(static), real_run(name, fn, args, static=static, **kw))[1])
    args = (torch.from_numpy(frame), torch.from_numpy(np.stack([blob(*b) for b in BLOBS[:2]])))
    for flip in (True, False):
        got = preprocess_frame_graphed(graphs, *args, out=64, pts=16, bgr_flip=flip)
        ref = preprocess_frame(*args, out=64, pts=16, bgr_flip=flip)
        assert all(torch.equal(got[k], ref[k]) for k in ref)
    assert statics == [(64, 16, False, True), (64, 16, False, False)]
