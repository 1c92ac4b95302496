"""The port's synthetic world (picopose_tpu_torch/synthetic_world.py) against
the JAX package's tool (tools/synthetic_world.py): one tiny world of three
objects (the L shape, the textured block, the symmetric cube), two scenes
and occlusion pairs, written by both as their users run them, at the same
seed.

Tolerance: none.  The file lists are equal; every JSON file is equal as
parsed JSON and every ``.npy`` array bitwise; every PNG and JPEG decodes
(with PIL, as the JAX package reads them) to equal arrays; the PLY files
are equal byte for byte.  The two sides draw from the same numpy
``Generator`` in the same order, render through the same C++ rasterizer
(the port's copy, built with the same flags) and encode the JPEG frames as
libjpeg does, so nothing in between may differ.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--train", "4", "--test", "6", "--objects", "lshape,tex,cube", "--pair_frac", "0.5", "--scenes", "2"]


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, n), root) for d, _, names in os.walk(root) for n in names)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    base = tmp_path_factory.mktemp("worlds")
    jax_root, port_root = str(base / "jax"), str(base / "port")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PICOPOSE_FORCE_CPU="1")
    procs = [
        subprocess.Popen([sys.executable, os.path.join(ROOT, "tools", "synthetic_world.py"), "--root", jax_root,
                          *FLAGS], cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
        subprocess.Popen([sys.executable, "-m", "picopose_tpu_torch.synthetic_world", "--root", port_root, *FLAGS],
                         cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
    ]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    # the summary lines: GT and target counts
    assert outs[0].replace(jax_root, "<root>").strip() == outs[1].replace(port_root, "<root>").strip(), outs
    return jax_root, port_root


def _pairs(worlds, *exts):
    jax_root, port_root = worlds
    names = [n for n in _files(jax_root) if n.endswith(exts)]
    assert names, exts
    return [(n, os.path.join(jax_root, n), os.path.join(port_root, n)) for n in names]


def test_same_files(worlds):
    jax_files, port_files = _files(worlds[0]), _files(worlds[1])
    assert jax_files == port_files
    kinds = {os.path.splitext(n)[1] for n in jax_files}
    assert kinds == {".json", ".npy", ".png", ".jpg", ".ply"}, kinds


def test_json_equal(worlds):
    pairs = _pairs(worlds, ".json")
    names = {os.path.basename(n) for n, _, _ in pairs}
    assert {"models_info.json", "scene_gt.json", "scene_gt_info.json", "fakeds.json",
            "test_targets_bop19.json", "key_to_shard.json"} <= names
    for name, a, b in pairs:
        with open(a) as fa, open(b) as fb:
            assert json.load(fa) == json.load(fb), name


def test_npy_equal(worlds):
    for name, a, b in _pairs(worlds, ".npy"):
        x, y = np.load(a), np.load(b)
        assert x.dtype == y.dtype and np.array_equal(x, y), name


@pytest.mark.parametrize("ext", [".png", ".jpg"])
def test_images_decode_equal(worlds, ext):
    kinds = set()
    for name, a, b in _pairs(worlds, ext):
        x, y = np.asarray(Image.open(a)), np.asarray(Image.open(b))
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert np.array_equal(x, y), name
        kinds.add((x.dtype.name, x.shape[2:]))
    # PNG: RGB frames and the texture atlas, 16-bit depth, RGBA bank views; JPEG: RGB frames
    want = {("uint8", (3,)), ("uint16", ()), ("uint8", (4,))} if ext == ".png" else {("uint8", (3,))}
    assert kinds == want, kinds


def test_ply_bytes_equal(worlds):
    for name, a, b in _pairs(worlds, ".ply"):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), name
