"""The port's serving path against the JAX package's, on the CPU.

Host-side decoding (RLE, square boxes, crop matrices, pts2d, the rgb and
mask crops), the on-device ``preprocess_frame``, the estimator's
``_decode`` / ``_device_batch``, bank files written by either package, and
``PoseEstimator.estimate`` against the port's ``run_batch`` (which
test_torch_run_batch.py holds against the JAX package).

Tolerances (measured max errors in brackets): boxes and masks exact;
crop matrices within 1e-6 relative [0]; pts2d within 1e-5 [0]; the rgb
crop within 2e-4 normalised units of cv2's INTER_LINEAR
(``crop_and_normalize_rgb_py``) [1.4e-14] and of the JAX estimator's
crop, which takes the native fastpath [2.7e-5]; ``preprocess_frame``
within 1e-5 of the JAX one at 64^2 [7.2e-7] and within 1e-3 of the
port's host crops [4.2e-7]; at 224^2 within 1e-4 of the JAX one [4.5e-5:
the same bilinear weights, but JAX's CPU einsum sits 4.4e-5 from their
fp64 product, the port 6.9e-6] and within 1e-3 of the host batch
[2.6e-5]; bank files bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picopose_tpu.data import crops as jcrops
from picopose_tpu.data.rle import rle_to_mask_py
from picopose_tpu.eval.pipeline import TemplateBank as JaxTemplateBank
from picopose_tpu.ops.preprocess import preprocess_frame as jax_preprocess_frame
from picopose_tpu.serve import PoseEstimator as JaxPoseEstimator
from picopose_tpu_torch.data import crops
from picopose_tpu_torch.data.rle import rle_to_mask
from picopose_tpu_torch.eval.pipeline import TemplateBank, build_bank, run_batch
from picopose_tpu_torch.ops.preprocess import preprocess_frame
from picopose_tpu_torch.serve import PoseEstimator

H, W = 120, 160
K = np.array([[300.0, 0, 80.0], [0, 300.0, 60.0], [0, 0, 1]], np.float32)
# blobs: centred, near the top-left border, near the bottom-right border, thin
BLOBS = [(60, 80, 25, 30), (8, 10, 12, 14), (112, 152, 18, 10), (60, 80, 40, 4)]


def blob(cy, cx, ry, rx):
    yy, xx = np.mgrid[:H, :W]
    return ((((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) <= 1.0).astype(np.uint8)


def rle_uncompressed(mask):
    flat = mask.flatten(order="F").astype(np.int8)
    edges = np.flatnonzero(np.diff(np.r_[0, flat, 1 - flat[-1]]))
    return {"size": list(mask.shape), "counts": np.diff(np.r_[0, edges]).tolist()}


def rle_compressed(mask):
    """COCO's compressed counts string (the inverse of the LEB128 decode)."""
    counts = rle_uncompressed(mask)["counts"]
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


@pytest.fixture(scope="module")
def frame():
    return np.random.default_rng(0).integers(0, 256, size=(H, W, 3), dtype=np.uint8)


@pytest.mark.parametrize("encode", [rle_uncompressed, rle_compressed])
def test_rle_decodes_as_the_jax_package(encode):
    rng = np.random.default_rng(1)
    for mask in [blob(*b) for b in BLOBS] + [(rng.random((H, W)) > 0.5).astype(np.uint8)]:
        rle = encode(mask)
        np.testing.assert_array_equal(rle_to_mask(rle), rle_to_mask_py(rle))
        np.testing.assert_array_equal(rle_to_mask(rle), mask)


@pytest.mark.parametrize("out", [64, 224])
def test_host_crops_match_the_jax_package(frame, out):
    """Boxes, M and pts2d as the JAX package's; rgb within 2e-4 of cv2's
    INTER_LINEAR, the mask equal to cv2's INTER_NEAREST, down- and
    upscaled crops alike."""
    for b in BLOBS:
        mask = blob(*b)
        bbox = crops.mask_square_bbox(mask)
        assert bbox == jcrops.mask_square_bbox(mask)
        raw = (b[0] - 20, b[0] + 15, b[1] - 30, b[1] + 5)
        assert crops.square_bbox(raw, (H, W)) == jcrops.square_bbox(raw, (H, W))
        M = crops.crop_matrix(bbox, out)
        np.testing.assert_allclose(M, jcrops.crop_matrix(bbox, out), rtol=1e-6)
        np.testing.assert_allclose(crops.grid_pts2d(M, out, 16), jcrops.grid_pts2d(M, out, 16), atol=1e-5)
        for mask_rgb in (False, True):
            got = crops.crop_and_normalize_rgb(frame, bbox, out, mask, mask_rgb)
            ref = jcrops.crop_and_normalize_rgb_py(frame, bbox, out, mask, mask_rgb)
            assert got.dtype == np.float32 and got.shape == (out, out, 3)
            np.testing.assert_allclose(got, ref, atol=2e-4)
        np.testing.assert_array_equal(crops.crop_mask(mask, bbox, out), jcrops.crop_mask(mask, bbox, out))


def _boxes():
    """Two masks, then two detector boxes (y1, y2, x1, x2) with their filled
    squares as masks."""
    masks, bboxes = [blob(*b) for b in BLOBS[:2]], [(0, 0, 0, 0)] * 2
    for box in [(20, 70, 30, 90), (50, 110, 80, 150)]:
        sq = jcrops.square_bbox(box, (H, W))
        m = np.zeros((H, W), np.uint8)
        m[sq[0]:sq[1], sq[2]:sq[3]] = 1
        masks.append(m)
        bboxes.append(box)
    return np.stack(masks), np.asarray(bboxes, np.int32), np.array([False, False, True, True])


@pytest.mark.parametrize("mask_rgb", [False, True])
def test_preprocess_frame_matches_jax_and_the_host_path(frame, mask_rgb):
    masks, bboxes, use = _boxes()
    kw = dict(out=64, pts=16, mask_rgb=mask_rgb)
    ref = jax_preprocess_frame(jnp.asarray(frame), jnp.asarray(masks), bboxes=jnp.asarray(bboxes),
                               use_bbox=jnp.asarray(use), **kw)
    got = preprocess_frame(torch.from_numpy(frame), torch.from_numpy(masks), bboxes=torch.from_numpy(bboxes),
                           use_bbox=torch.from_numpy(use), **kw)
    np.testing.assert_allclose(got["real_rgb"].numpy(), np.asarray(ref["real_rgb"]), atol=1e-5)
    np.testing.assert_array_equal(got["real_mask"].numpy(), np.asarray(ref["real_mask"]))
    np.testing.assert_allclose(got["real_M"].numpy(), np.asarray(ref["real_M"]), rtol=1e-6)
    np.testing.assert_allclose(got["real_pts2d"].numpy(), np.asarray(ref["real_pts2d"]), atol=1e-5)
    for i in range(len(masks)):
        sq = crops.square_bbox(bboxes[i], (H, W)) if use[i] else crops.mask_square_bbox(masks[i])
        host = crops.crop_and_normalize_rgb(frame, sq, 64, masks[i], mask_rgb)
        np.testing.assert_allclose(got["real_rgb"][i].numpy(), host, atol=1e-3)
        np.testing.assert_array_equal(got["real_mask"][i].numpy(), crops.crop_mask(masks[i], sq, 64))


@pytest.fixture(scope="module")
def estimator():
    """A small fp32 estimator on the CPU with one 6-view bank, registered as
    objects 1 and 2."""
    with pytest.warns(UserWarning, match="RANDOM weights"):
        est = PoseEstimator(vit_type="vit_tiny_test", blocks_to_take=(0, 1, 2, 3), compute_dtype="float32",
                            hyp=2, pnp_iters=8, stage3_topk=1, max_batch=2, device="cpu")
    rng = np.random.default_rng(2)
    n = 6
    eye = lambda k: np.tile(np.eye(k, dtype=np.float32), (n, 1, 1))
    pose = eye(4)
    pose[:, 2, 3] = 0.5
    f32 = lambda a: np.asarray(a, np.float32)
    bank = build_bank(
        est.model, f32(rng.normal(size=(n, 224, 224, 3))), f32(rng.random((n, 224, 224)) > 0.3),
        f32(rng.normal(size=(n, 64, 64, 3)) + [0, 0, 1]), pose, f32(eye(3) * [300, 300, 1]), eye(3), chunk=4,
    )
    est.register_bank(1, bank)
    est.register_bank(2, bank)
    return est


def _jax_estimator(**attrs):
    est = JaxPoseEstimator.__new__(JaxPoseEstimator)  # no model: decoding only
    est.img_size, est.pts_size, est.min_mask_px, est.rgb_mask_flag = 224, 64, 8, False
    est._jnp, est._devices, est._banks, est._bank_device = jnp, None, {}, {}
    est.__dict__.update(attrs)
    return est


def _detections():
    masks, _, _ = _boxes()
    return [
        {"obj_id": 1, "mask": masks[0]},
        {"obj_id": 1, "segmentation": rle_compressed(masks[1])},
        {"obj_id": 1, "bbox": [30, 20, 60, 50]},  # xywh
        {"category_id": 1, "mask": np.zeros((H, W), np.uint8), "bbox": [80, 50, 70, 60]},  # empty mask: the box
        {"obj_id": 1, "segmentation": rle_uncompressed(blob(*BLOBS[3]))},
    ]


def test_decode_and_device_batch_match_the_jax_estimator(frame, estimator):
    jest = _jax_estimator()
    dets = _detections()
    for det in dets:
        got, ref = estimator._decode(frame, K, det), jest._decode(frame, K, det)
        np.testing.assert_allclose(got["rgb"], ref["rgb"], atol=2e-4)
        np.testing.assert_array_equal(got["mask"], ref["mask"])
        np.testing.assert_allclose(got["M"], ref["M"], rtol=1e-6)
        np.testing.assert_allclose(got["pts2d"], ref["pts2d"], atol=1e-5)
        np.testing.assert_array_equal(got["K"], ref["K"])
    got = estimator._device_batch(frame, K, dets, pad=1)
    ref = jest._device_batch(frame, K, dets, pad=1, dev=None)
    assert got["real_rgb"].shape == (len(dets) + 1, 224, 224, 3)
    np.testing.assert_allclose(got["real_rgb"].numpy(), np.asarray(ref["real_rgb"]), atol=1e-4)
    np.testing.assert_array_equal(got["real_mask"].numpy(), np.asarray(ref["real_mask"]))
    np.testing.assert_allclose(got["real_M"].numpy(), np.asarray(ref["real_M"]), rtol=1e-6)
    np.testing.assert_allclose(got["real_pts2d"].numpy(), np.asarray(ref["real_pts2d"]), atol=1e-5)
    np.testing.assert_array_equal(got["real_K"].numpy(), np.asarray(ref["real_K"]))
    host = estimator._host_batch(frame, K, dets, pad=1)
    for k in host:
        np.testing.assert_allclose(got[k].numpy(), host[k].numpy(), atol=1e-3, err_msg=k)


def _bank_arrays(rng):
    bf16 = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(
        feats=[bf16(3, 16, 16, 32) for _ in range(4)], dpt=[bf16(3, g, g, 8) for g in (16, 32, 64)],
        mask=(rng.random((3, 224, 224)) > 0.5).astype(np.float32), pts3d=bf16(3, 64, 64, 3),
        pose=bf16(3, 4, 4), K=bf16(3, 3, 3), M=bf16(3, 3, 3),
    )


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_bank_files_load_in_the_other_package(tmp_path, writer):
    """bf16 taps and pyramids as raw uint16 under the ("bf16",) tag, the
    rest fp32: a file written by either package loads bitwise in both."""
    a = _bank_arrays(np.random.default_rng(3))
    jbank = JaxTemplateBank(
        feats=tuple(jnp.asarray(f, jnp.bfloat16) for f in a["feats"]),
        mask=jnp.asarray(a["mask"]), pts3d=jnp.asarray(a["pts3d"]), pose=jnp.asarray(a["pose"]),
        K=jnp.asarray(a["K"]), M=jnp.asarray(a["M"]), dpt=tuple(jnp.asarray(d, jnp.bfloat16) for d in a["dpt"]),
    )
    jest = _jax_estimator()
    test = PoseEstimator.__new__(PoseEstimator)  # no model: bank files only
    test.device, test._banks = torch.device("cpu"), {}
    if writer == "jax":
        jest._banks[7] = jbank
        jest.save_banks(str(tmp_path))
        assert test.load_banks(str(tmp_path)) == [7]
    else:
        test.register_bank(7, TemplateBank(
            feats=tuple(torch.from_numpy(f).bfloat16() for f in a["feats"]),
            dpt=tuple(torch.from_numpy(d).bfloat16() for d in a["dpt"]),
            **{k: torch.from_numpy(a[k]) for k in ("mask", "pts3d", "pose", "K", "M")},
        ))
        test.save_banks(str(tmp_path))
        assert jest.load_banks(str(tmp_path)) == [7]
    tbank, jbank = test._banks[7], jest._banks[7]
    bits = lambda x: np.asarray(jax.lax.bitcast_convert_type(x, jnp.uint16))
    for t, j in zip(tbank.feats + tbank.dpt, jbank.feats + jbank.dpt):
        assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16), bits(j))
    for k in ("mask", "pts3d", "pose", "K", "M"):
        t, j = getattr(tbank, k), np.asarray(getattr(jbank, k))
        assert t.dtype == torch.float32 and j.dtype == np.float32
        np.testing.assert_array_equal(t.numpy(), j)


def test_estimate_equals_run_batch_on_the_assembled_batch(frame, estimator):
    dets = [{"obj_id": 1, "mask": blob(*BLOBS[0])}, {"obj_id": 1, "bbox": [30, 20, 60, 50]}]
    seed = lambda: torch.Generator().manual_seed(5)
    estimator.generator = seed()
    res = estimator.estimate(frame, K, dets)
    out = run_batch(estimator.model, estimator._host_batch(frame, K, dets, pad=0), estimator._banks[1],
                    hyp=2, pnp_iters=8, stage3_topk=1, generator=seed())
    for i, r in enumerate(res):
        assert r.obj_id == 1 and isinstance(r.success, bool)
        np.testing.assert_array_equal(r.R, out.R[i, 0].numpy())
        np.testing.assert_array_equal(r.t, out.t[i, 0].numpy())
        assert r.score == out.inlier_ratio[i, 0].item() and r.success == bool(out.pnp_success[i, 0])
        assert r.template_score == out.template_score[i, 0].item()
        np.testing.assert_allclose(r.R @ r.R.T, np.eye(3), atol=1e-4)


def test_estimate_keeps_order_across_objects_and_chunks(frame, estimator):
    """Five detections over two objects with max_batch 2: object 1's three
    make two chunks (the second padded), object 2's two one.  Each result
    carries its own detection's stage-1 score; the on-device crops give
    the same scores within 1e-4."""
    dets = _detections()
    for d, obj in zip(dets, [1, 2, 1, 2, 1]):
        d.pop("category_id", None)
        d["obj_id"] = obj
    res = estimator.estimate(frame, K, dets)
    assert [r.obj_id for r in res] == [1, 2, 1, 2, 1]
    alone = [estimator.estimate(frame, K, [d])[0].template_score for d in dets]
    np.testing.assert_allclose([r.template_score for r in res], alone, atol=1e-6)
    assert len(set(np.round(alone, 6))) == len(dets)  # distinct crops: the order is visible
    for r in res:
        assert np.isfinite(r.R).all() and np.isfinite(r.t).all()
    estimator.device_preprocess = True
    try:
        dev = estimator.estimate(frame, K, dets)
    finally:
        estimator.device_preprocess = False
    np.testing.assert_allclose([r.template_score for r in dev], alone, atol=1e-4)


def test_estimate_raises_on_an_unregistered_object(frame, estimator):
    with pytest.raises(KeyError, match="not registered"):
        estimator.estimate(frame, K, [{"obj_id": 7, "bbox": [0, 0, 10, 10]}])
    with pytest.raises(ValueError, match="bbox"):
        estimator.estimate(frame, K, [{"obj_id": 1, "mask": np.zeros((H, W), np.uint8)}])
    assert estimator.objects == [1, 2]
    assert estimator.estimate(frame, K, []) == []
