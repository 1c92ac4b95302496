"""The port's BOP test-set loading (data/bop.py) and CSV writer
(eval/bop_csv.py) against the JAX package's, on the CPU.

The tree of tests/torch_bop_tree.py (written with PIL from seeded numpy
images: two objects with 6 RGBA views and 16-bit depth each, three frames
in two scenes, RGB and grey).  The JAX crops take their cv2 path
(PICOPOSE_NO_FASTPATH=1), the oracle the port's crops are held to.
Tolerances: keys, object ids, ``dets``, ``image_meta`` and ``load_raw``
equal (bitwise); ``decode_instance`` within 1e-5 (boxes, masks, K
exact); ``load_template_views`` within 1e-5 with ``tem_pts3d``, poses
and K exact; CSV rows byte for byte.
"""

import os
import shutil

import numpy as np
import pytest
from PIL import Image
from torch_bop_tree import write_bop_tree

from picopose_tpu.data import bop as jbop
from picopose_tpu.eval.bop_csv import format_row as jax_format_row
from picopose_tpu_torch.data import bop
from picopose_tpu_torch.eval.bop_csv import format_row, write_csv


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_bop_tree(str(tmp_path_factory.mktemp("bop")), n_views=6)


@pytest.fixture(scope="module")
def datasets(tree):
    args = (tree["data_dir"], "fakeds", tree["det_path"])
    return bop.BOPTestDataset(*args, n_template_view=6), jbop.BOPTestDataset(*args, n_template_view=6)


@pytest.fixture(autouse=True)
def cv2_crops(monkeypatch):
    monkeypatch.setenv("PICOPOSE_NO_FASTPATH", "1")


def test_constants_are_the_jax_package_s():
    np.testing.assert_array_equal(bop.TEMPLATES_K, jbop.TEMPLATES_K)
    assert bop.TEMPLATES_K.dtype == jbop.TEMPLATES_K.dtype
    assert bop.DETECTION_FILES == jbop.DETECTION_FILES and bop.BOP7 == jbop.BOP7


def test_metadata_matches(datasets):
    got, ref = datasets
    assert got.keys == ref.keys and len(got) == len(ref) == 3
    assert got.obj_ids == ref.obj_ids == [1, 3] and got.obj_idx == ref.obj_idx
    for i in range(len(ref)):
        assert got.dets(i) == ref.dets(i)
        assert vars(got.image_meta(i)) == vars(ref.image_meta(i))
    # the top-inst_count, score-filter and category-backfill rules all acted
    assert [[(d["category_id"], d["score"]) for d in got.dets(i)] for i in range(3)] == [
        [(1, 0.9), (1, 0.8), (3, 0.75)], [(3, 0.6), (3, 0.55)], [(1, 0.85)]]


def test_frames_and_instances_match(datasets):
    got, ref = datasets
    for i in range(len(ref)):
        (rgb, K), (r_rgb, r_K) = got.load_raw(i), ref.load_raw(i)
        assert rgb.dtype == r_rgb.dtype == np.uint8 and rgb.shape == r_rgb.shape and rgb.shape[-1] == 3
        np.testing.assert_array_equal(rgb, r_rgb)
        np.testing.assert_array_equal(K, r_K)
        for det in ref.dets(i):
            a, b = got.decode_instance(rgb, K, det), ref.decode_instance(r_rgb, r_K, det)
            assert (a.obj_id, a.score) == (b.obj_id, b.score)
            for name in ("rgb", "M", "pts2d"):
                x, y = getattr(a, name), getattr(b, name)
                assert x.dtype == y.dtype and x.shape == y.shape
                np.testing.assert_allclose(x, y, atol=1e-5, err_msg=name)
            np.testing.assert_array_equal(a.mask, b.mask)
            np.testing.assert_array_equal(a.K, b.K)
        loaded, r_loaded = got.load_image(i), ref.load_image(i)
        assert len(loaded.instances) == len(r_loaded.instances) == len(ref.dets(i))


@pytest.mark.parametrize("obj", [1, 3])
def test_template_views_match(tree, obj):
    got = bop.load_template_views(tree["template_dir"], obj, 6)
    ref = jbop.load_template_views(tree["template_dir"], obj, 6)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k], ref[k], atol=1e-5, err_msg=k)
    for k in ("tem_pts3d", "tem_pose", "tem_K", "tem_mask"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    # the rim's alpha (100) is not opaque: the crop mask keeps 0/1 only
    assert set(np.unique(got["tem_mask"])) <= {0.0, 1.0}


def test_jpeg_and_tiff_frames_raise(tree, tmp_path):
    """A ``.jpg`` frame (found before the ``.png``) decodes as PIL decodes
    it, and a truncated one raises naming the file; a ``.tif`` frame raises
    (no TIFF decoder yet)."""
    root = tmp_path / "bop"
    shutil.copytree(tree["data_dir"], root)
    ds = bop.BOPTestDataset(str(root), "fakeds", tree["det_path"])
    scene = root / "fakeds" / "test" / "000001"
    jpg = scene / "rgb" / "000000.jpg"
    Image.open(scene / "rgb" / "000000.png").save(jpg, quality=90)
    rgb, K = ds.load_raw(0)
    np.testing.assert_array_equal(rgb, np.asarray(Image.open(jpg)))
    jds = jbop.BOPTestDataset(str(root), "fakeds", tree["det_path"])
    np.testing.assert_array_equal(rgb, jds.load_raw(0)[0])
    jpg.write_bytes(jpg.read_bytes()[: len(jpg.read_bytes()) // 2])
    with pytest.raises(ValueError, match="000000.jpg"):
        ds.load_raw(0)
    os.remove(scene / "rgb" / "000002.png")
    os.makedirs(scene / "gray")
    (scene / "gray" / "000002.tif").write_bytes(b"II*\x00")
    with pytest.raises(NotImplementedError, match="000002.tif"):
        ds.load_raw(1)


def test_csv_rows_are_byte_identical(tmp_path):
    rng = np.random.default_rng(0)
    rows, ref = [], []
    for i in range(5):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        R, t = q.astype(np.float32), rng.normal(size=3).astype(np.float32)
        args = (i + 1, 10 * i, 3, float(rng.uniform()), R, t, float(rng.uniform(0, 2)))
        rows.append(format_row(*args))
        ref.append(jax_format_row(*args))
    assert rows == ref
    write_csv(str(tmp_path / "x.csv"), rows)
    assert (tmp_path / "x.csv").read_text() == "".join(ref)
