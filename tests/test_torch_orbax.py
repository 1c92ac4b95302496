"""The JAX package's orbax checkpoints read by the port without JAX, orbax
or tensorstore (native/csrc/zstd.cpp, utils/ocdbt.py, utils/zarr2.py,
utils/orbax_read.py, utils/checkpoint.py), against tensorstore, zstandard
and the JAX package, on the CPU.  Every input is written here by
tensorstore, orbax (through the JAX package's own ``save``) or zstandard.

* The zstd decoder, bitwise: zarr chunks that tensorstore compresses at
  levels 1, 3, 9, 19 and 22 (constant, random, fp32-normal and
  repetitive bytes; 1 byte, 128 KiB - 1, 128 KiB, 128 KiB + 1 and 20 MB,
  20 MB not at 19 and 22 for the random kinds, ~20 s a frame); frames
  zstandard writes with a content size and a checksum (0 bytes, which no
  zarr chunk holds); every frame header flag combination, skippable and
  concatenated frames, RLE and raw literals assembled here; a census of
  the format's parts the corpus reaches.  Truncated frames raise;
  bit-flipped frames raise or decode exactly (a window descriptor's bit
  can change nothing); nothing is written past the capacity.
* OCDBT ``list`` / ``read`` equal tensorstore's on every key of orbax
  checkpoints (the small model's variables, a multi-chunk tree of mixed
  dtypes, an AdamW ``TrainState``; each root and its per-process store)
  and of stores tensorstore writes with small nodes (interior nodes), an
  arity-2 version tree (version tree nodes) and without compression.
  A flipped byte of a node or manifest raises (CRC32C).
* zarr v2 arrays tensorstore writes over OCDBT: every dtype, partial edge
  chunks, missing chunks (fill value), the "/" separator, no compressor,
  0-d; order "F" and another compressor raise.  Regions of every dtype
  (blocks of ranges, partial edge chunks, an empty part) are bitwise the
  slices of a whole read and decode the chunks that meet them.
* ``load_any`` of a variables and of a ``TrainState`` step directory, leaf
  for leaf bitwise (dtype and shape) the JAX package's ``load_any``;
  ``PoseEstimator`` and ``run_test`` (``--iter`` on a JAX log dir) give
  the rows they give from the same variables; ``warm_start``,
  ``export_torch`` (bitwise tools/export_torch.py's file) and
  ``run_training(resume=True)`` on a JAX log dir.
* Resume: the JAX ``make_train_step`` at the parity tests' small config
  takes 2 steps (AdamW) or 3 (grad_accum 2: one update, then one
  gradient accumulated), saved by ``picopose_tpu.utils.checkpoint.save``;
  the port restores it (bitwise the saved state, mapped) and the JAX
  package restores it, and each takes one more step, which updates:
  tests/test_torch_train_compiled.py's tolerances (losses within 1e-4
  relative, the state's change within 1e-2 relative RMS per parameter
  group, every parameter within 2 lr of the JAX one).
* The committed fixtures (tests/data/orbax_small/, and orbax_sharded/,
  two JAX processes' save over a 2 x 2 fsdp_tp mesh) read as
  tests/make_orbax_fixture.py would write them, each leaf of orbax_sharded
  bitwise orbax_small's; a corrupt chunk in its ``ocdbt.process_1/``
  raises naming its file.  Restored at data rank 1 of fsdp over 2 (a mesh
  without a process group), each leaf decodes exactly the chunks that
  meet the rank's part, found here from the port's weight conversion and
  ``shard_of`` of leaves of flat indices, and the rank's tensors are
  bitwise ``shard_of`` of the one-process restore.
"""

import collections
import json
import math
import os
import re
import shutil
import subprocess
import sys

import google_crc32c
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as tstore
import torch
import zstandard
from test_torch_cli_export import _jax_tool
from test_torch_train_losses import jax_affine_noise
from test_torch_train_step import OPT, _batch, _rel_rms_by_group
from torch_bop_tree import write_bop_tree, write_megapose_tree
from torch_parity import SMALL, random_flax_variables

import make_orbax_fixture
from picopose_tpu.models import PicoPose as JaxPicoPose
from picopose_tpu.train import step as js
from picopose_tpu.utils import checkpoint as jckpt
from picopose_tpu.utils.torch_export import save_torch_checkpoint as jax_save_torch_checkpoint
from picopose_tpu_torch import export_torch, run_test
from picopose_tpu_torch.native import codec
from picopose_tpu_torch.native.codec import ZstdError, crc32c, zstd_decompress
from picopose_tpu_torch.serve import PoseEstimator
from picopose_tpu_torch.parallel.mesh import Mesh
from picopose_tpu_torch.parallel.shardings import (
    flax_leaf, local_optimizer_state, shard_of, shard_state, state_shardings,
)
from picopose_tpu_torch.train import loop as T
from picopose_tpu_torch.train import step as ts
from picopose_tpu_torch.utils import checkpoint as ckpt
from picopose_tpu_torch.utils import zarr2
from picopose_tpu_torch.utils.config import load_config
from picopose_tpu_torch.utils.ocdbt import OcdbtError, OcdbtStore, Ref
from picopose_tpu_torch.utils.orbax_read import read_step_dir
from picopose_tpu_torch.utils.weights import state_dict_from_flax
from picopose_tpu_torch.utils.zarr2 import ZarrError, read_array

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KIB128 = 128 * 1024
LEVELS = (1, 3, 9, 19, 22)
KINDS = ("constant", "random", "fp32", "repetitive")
B = 2


# ---------------------------------------------------------------- helpers


def _data(kind: str, n: int, seed: int = 0) -> bytes:
    rng = np.random.default_rng([seed, n])
    if kind == "constant":
        return bytes([7]) * n
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == "fp32":
        return rng.standard_normal(n // 4 + 1).astype(np.float32).tobytes()[:n]
    # words from a small vocabulary: long and short matches, repeat offsets, literals
    words = [rng.integers(97, 123, rng.integers(2, 12), dtype=np.uint8).tobytes() for _ in range(300)]
    out = b" ".join(words[i] for i in rng.integers(0, 300, n // 4 + 16))
    return out[:n]


def _zarr_frame(root: str, data: bytes, level: int) -> bytes:
    """The chunk tensorstore's zarr store writes for ``data`` (one chunk
    of |u1) with its zstd compressor at ``level``: one zstd frame."""
    arr = tstore.open({
        "driver": "zarr", "kvstore": {"driver": "file", "path": root}, "path": "a",
        "metadata": {"shape": [len(data)], "chunks": [len(data)], "dtype": "|u1",
                     "compressor": {"id": "zstd", "level": level}},
        "create": True, "delete_existing": True,
    }).result()
    arr.write(np.frombuffer(data, np.uint8)).result()
    with open(os.path.join(root, "a", "0"), "rb") as f:
        return f.read()


def _header_size(frame: bytes) -> int:
    fhd = frame[4]
    single, did, fcs = (fhd >> 5) & 1, fhd & 3, fhd >> 6
    fcs_size = (1 if single else 0) if fcs == 0 else (2, 4, 8)[fcs - 1]
    return 5 + (0 if single else 1) + (0, 1, 2, 4)[did] + fcs_size


def _reframe(data: bytes, fcs_flag: int, single: bool, did_flag: int, checksum: bool, did: int = 0) -> bytes:
    """``data`` zstandard-compressed, its frame header rewritten with these
    flags (window 1 KiB when there is a window descriptor)."""
    src = zstandard.ZstdCompressor(level=3, write_checksum=True, write_content_size=True).compress(data)
    blocks, digest = src[_header_size(src):-4], src[-4:]
    n = len(data)
    fcs_size = (1 if single else 0) if fcs_flag == 0 else (2, 4, 8)[fcs_flag - 1]
    value = n - 256 if fcs_size == 2 else n
    fhd = (fcs_flag << 6) | (int(single) << 5) | (int(checksum) << 2) | did_flag
    head = bytes([0x28, 0xB5, 0x2F, 0xFD, fhd])
    if not single:
        head += bytes([0x00])  # window 1 KiB
    head += did.to_bytes((0, 1, 2, 4)[did_flag], "little") + (value.to_bytes(fcs_size, "little") if fcs_size else b"")
    return head + blocks + (digest if checksum else b"")


def _skippable(payload: bytes, nibble: int = 0) -> bytes:
    return (0x184D2A50 + nibble).to_bytes(4, "little") + len(payload).to_bytes(4, "little") + payload


def _literals_frame(kind: int, n: int, byte: int = 0x5A) -> bytes:
    """A single-segment frame of one compressed block that holds only a
    literals section (raw: kind 0, RLE: kind 1) of ``n`` bytes and no
    sequences, with a 1-, 2- or 3-byte literals header as ``n`` needs."""
    if n < 32:
        hdr = bytes([(n << 3) | kind])
    elif n < 4096:
        hdr = bytes([((n & 15) << 4) | (1 << 2) | kind, n >> 4])
    else:
        hdr = bytes([((n & 15) << 4) | (3 << 2) | kind, (n >> 4) & 255, n >> 12])
    body = hdr + (bytes([byte]) * n if kind == 0 else bytes([byte])) + b"\x00"
    bh = 1 | (2 << 1) | (len(body) << 3)
    return bytes([0x28, 0xB5, 0x2F, 0xFD, 0xA0]) + n.to_bytes(4, "little") + bh.to_bytes(3, "little") + body


def _guarded(src: bytes, cap: int):
    """Decode into the first ``cap`` bytes of a buffer whose tail holds a
    sentinel; returns (result or the exception, whether the tail held)."""
    buf = np.full(cap + 64, 0xA5, np.uint8)
    try:
        out = zstd_decompress(src, cap, out=buf[:cap]).tobytes()
    except ZstdError as e:
        out = e
    return out, bool((buf[cap:] == 0xA5).all())


# ---------------------------------------------------------------- zstd


@pytest.mark.parametrize("size", [1, KIB128 - 1, KIB128, KIB128 + 1])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("level", LEVELS)
def test_tensorstore_zstd_chunks_decode_bitwise(tmp_path, level, kind, size):
    data = _data(kind, size)
    frame = _zarr_frame(str(tmp_path), data, level)
    assert frame[:4] == bytes.fromhex("28b52ffd")
    assert zstd_decompress(frame, size).tobytes() == data


@pytest.mark.parametrize("kind,level", [(k, lv) for k in KINDS for lv in LEVELS
                                        if lv <= 9 or k in ("constant", "repetitive")])
def test_tensorstore_zstd_20mb_chunks_decode_bitwise(tmp_path, kind, level):
    n = 20 * 1000 * 1000
    data = _data(kind, n, seed=1)
    frame = _zarr_frame(str(tmp_path), data, level)
    assert zstd_decompress(frame, n).tobytes() == data


@pytest.mark.parametrize("size", [0, 1, 255, 256, 65791, 65792, KIB128 + 1])
@pytest.mark.parametrize("level", [1, 19])
def test_zstandard_frames_with_content_size_and_checksum(level, size):
    data = _data("repetitive", size)
    for checksum in (False, True):
        frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(data)
        assert zstd_decompress(frame, size).tobytes() == data
        if checksum and size:  # a wrong checksum raises
            bad = frame[:-4] + bytes(b ^ 1 for b in frame[-4:])
            with pytest.raises(ZstdError, match="content checksum mismatch"):
                zstd_decompress(bad, size)


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("did_flag", [0, 1, 2, 3])
@pytest.mark.parametrize("single,fcs_flag", [(False, 0), (False, 1), (False, 2), (False, 3),
                                             (True, 0), (True, 1), (True, 2), (True, 3)])
def test_every_frame_header_flag_combination(single, fcs_flag, did_flag, checksum):
    """Content size absent or of 1, 2, 4 or 8 bytes, window descriptor or
    single segment, a dictionary ID of 0 in 1, 2 or 4 bytes (no
    dictionary), checksum or none; a dictionary ID other than 0 raises."""
    data = _data("repetitive", 200 if (single and fcs_flag == 0) else 300)
    frame = _reframe(data, fcs_flag, single, did_flag, checksum)
    assert zstd_decompress(frame, len(data)).tobytes() == data
    if did_flag:
        with pytest.raises(ZstdError, match="dictionary 9"):
            zstd_decompress(_reframe(data, fcs_flag, single, did_flag, checksum, did=9), len(data))


def test_skippable_and_concatenated_frames():
    a, b = _data("fp32", 5000), _data("repetitive", 70000)
    za = zstandard.ZstdCompressor(level=19).compress(a)
    zb = zstandard.ZstdCompressor(level=1, write_checksum=True, write_content_size=False).compress(b)
    stream = _skippable(b"") + za + _skippable(b"metadata" * 9, 15) + zb + za + _skippable(bytes(3), 7)
    assert zstd_decompress(stream, 2 * len(a) + len(b)).tobytes() == a + b + a
    with pytest.raises(ZstdError, match="skippable frame truncated"):
        zstd_decompress(za + _skippable(b"xyz")[:-1], len(a))


@pytest.mark.parametrize("n", [0, 5, 31, 32, 4095, 4096, KIB128 - 4])
@pytest.mark.parametrize("kind", [0, 1])
def test_raw_and_rle_literals_sections(kind, n):
    assert zstd_decompress(_literals_frame(kind, n), n).tobytes() == bytes([0x5A]) * n


def test_the_corpus_reaches_every_part_of_the_format(tmp_path):
    """A corpus like the tests' decoded after ``census()``: every frame
    header field, block type, literals kind, Huffman weights form and
    table mode, and the repeat offsets (shifted under a zero literal
    length) are met."""
    codec.census()
    corpus = []
    for kind in KINDS:
        data = _data(kind, 3 * KIB128 + 17)
        for level in (1, 19):
            corpus.append((_zarr_frame(str(tmp_path), data, level), data))
    small = bytes(np.random.default_rng(3).integers(0, 5, 4000, dtype=np.uint8))  # few symbols: direct weights
    corpus.append((zstandard.ZstdCompressor(level=3).compress(small), small))
    data = _data("repetitive", 300)
    corpus += [(_reframe(data, f, False, d, True), data) for f in range(4) for d in range(4)]
    corpus += [(_reframe(data[:200], 0, True, 0, False), data[:200]), (_skippable(b"x") + _literals_frame(1, 100),
                                                                        bytes([0x5A]) * 100)]
    corpus.append((_literals_frame(0, 9), bytes([0x5A]) * 9))
    for frame, data in corpus:
        assert zstd_decompress(frame, len(data)).tobytes() == data
    seen = codec.census()
    assert set(seen) == set(codec.CENSUS)
    assert all(v > 0 for v in seen.values()), {k: v for k, v in seen.items() if not v}


def test_truncated_frames_raise():
    for data in (_data("fp32", 3000), _data("repetitive", 20000), b"abc"):
        for checksum in (False, True):
            frame = zstandard.ZstdCompressor(level=3, write_checksum=checksum).compress(data)
            for cut in range(len(frame)):
                out, tail_held = _guarded(frame[:cut], len(data))
                assert isinstance(out, ZstdError), (len(data), checksum, cut)
                assert tail_held


@pytest.mark.parametrize("kind", ["fp32", "repetitive"])
def test_bit_flipped_frames_raise_or_decode_exactly(kind):
    """With a checksum every flip of a sampled bit raises or gives the
    original bytes (a window descriptor bit that keeps every match inside
    the window changes nothing); without one a flip may decode to other
    bytes, and the buffer's tail stays untouched either way."""
    data = _data(kind, 6000)
    rng = np.random.default_rng(5)
    for checksum in (True, False):
        frame = bytearray(zstandard.ZstdCompressor(level=9, write_checksum=checksum).compress(data))
        for bit in rng.choice(len(frame) * 8, 300, replace=False):
            bad = bytearray(frame)
            bad[bit // 8] ^= 1 << (bit % 8)
            out, tail_held = _guarded(bytes(bad), len(data))
            assert tail_held, bit
            if checksum:
                assert isinstance(out, ZstdError) or out == data, bit


def test_capacity_overruns_raise_with_the_offset_and_write_nothing_past_it():
    data = _data("repetitive", 50000)
    for frame in (zstandard.ZstdCompressor(level=3).compress(data),
                  zstandard.ZstdCompressor(level=3, write_content_size=False).compress(data)):
        out, tail_held = _guarded(frame, len(data) - 1)
        assert isinstance(out, ZstdError) and tail_held
        assert "dst_capacity" in str(out) and str(out).startswith("zstd frame at byte ")
    with pytest.raises(ZstdError, match="not a zstd frame"):
        zstd_decompress(b"\x00" * 16, 16)


def test_crc32c_matches_google_crc32c():
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 8, 9, 63, 1000, 100_003):
        b = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert crc32c(b) == google_crc32c.value(b)


def test_no_compiler_raises_naming_it_and_no_fastpath_does_not_switch_the_reader(tmp_path):
    """Without the host library the reader raises with the build's cause
    (no Python decoder stands in); PICOPOSE_NO_FASTPATH=1 leaves it on
    the library."""
    fixture = os.path.join(make_orbax_fixture.OUT, "variables", "checkpoints", "3")
    code = (
        "import sys, picopose_tpu_torch.native as n\n"
        f"n.BUILD_DIR = {str(tmp_path)!r}\n"
        "from picopose_tpu_torch.utils.orbax_read import read_step_dir\n"
        "try:\n"
        f"    read_step_dir({fixture!r})\n"
        "except RuntimeError as e:\n"
        "    print('raised:', e)\n"
    )
    env = dict(os.environ, CXX="no-such-compiler")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120, check=True).stdout
    assert "raised: C++ compiler 'no-such-compiler' not found" in out
    env = dict(os.environ, PICOPOSE_NO_FASTPATH="1")
    code = ("from picopose_tpu_torch.native import CALLS\n"
            "from picopose_tpu_torch.utils.orbax_read import read_step_dir\n"
            f"read_step_dir({fixture!r})\nprint(CALLS['zstd_decompress'] > 100)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120, check=True).stdout
    assert out.strip() == "True"


# ---------------------------------------------------------------- zarr v2 over OCDBT


ZARR_DTYPES = ["<f4", "<f8", "<i4", "<i8", "<u4", "|u1", "|b1", "bfloat16", ">f4", "<f2", "<i2"]


def _zarr_over_ocdbt(root: str, name: str, data: np.ndarray, chunks, dtype: str, **metadata):
    arr = tstore.open({
        "driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{root}/"}, "path": name,
        "metadata": {"shape": list(data.shape), "chunks": list(chunks), "dtype": dtype, **metadata},
        "create": True,
    }).result()
    return arr


def _values(dtype: str, shape, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == "bfloat16":
        return rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
    dt = np.dtype(dtype)
    if dt.kind == "b":
        return rng.random(shape) > 0.5
    if dt.kind == "f":
        return rng.standard_normal(shape).astype(dt)
    return rng.integers(-100 if dt.kind == "i" else 0, 200, shape).astype(dt)


def _as_numpy(got: np.ndarray) -> np.ndarray:
    return got.view(np.uint16) if got.dtype.names == ("bf16",) else got


def _bits(ref: np.ndarray) -> np.ndarray:
    return ref.view(np.uint16) if ref.dtype == ml_dtypes.bfloat16 else ref


@pytest.mark.parametrize("dtype", ZARR_DTYPES)
def test_zarr_arrays_of_every_dtype_with_partial_edge_chunks(tmp_path, dtype):
    data = _values(dtype, (37, 23, 3))
    _zarr_over_ocdbt(str(tmp_path), "x", data, (16, 10, 2), dtype,
                     compressor={"id": "zstd", "level": 5}).write(data).result()
    got = read_array(OcdbtStore(str(tmp_path)), "x")
    ref = _bits(data)
    assert got.shape == data.shape and np.array_equal(_as_numpy(got), ref)
    assert (got.dtype.names == ("bf16",)) if dtype == "bfloat16" else got.dtype == np.dtype(dtype).newbyteorder("=")


def test_zarr_missing_chunks_separator_no_compressor_and_0d(tmp_path):
    root = str(tmp_path)
    data = _values("<f4", (20, 30))
    arr = _zarr_over_ocdbt(root, "part", data, (8, 8), "<f4", fill_value=1.5, dimension_separator="/",
                           compressor=None)
    arr[8:16, 0:16].write(data[8:16, 0:16]).result()  # four chunks written; the rest are absent
    scalar = np.asarray(np.float64(2.25))
    _zarr_over_ocdbt(root, "s", scalar, (), "<f8", compressor={"id": "zstd", "level": 1}).write(scalar).result()
    bf = _values("bfloat16", (5,))
    _zarr_over_ocdbt(root, "bf", bf, (2,), "bfloat16", fill_value=-0.5,
                     compressor={"id": "zstd", "level": 1}).write(bf).result()
    store = OcdbtStore(root)
    assert "part/1/0" in store and "part/0/0" not in store
    got = read_array(store, "part")
    ref = np.full((20, 30), 1.5, np.float32)
    ref[8:16, 0:16] = data[8:16, 0:16]
    assert np.array_equal(got, ref)
    s = read_array(store, "s")
    assert s.shape == () and s.dtype == np.float64 and s == 2.25
    assert np.array_equal(read_array(store, "bf").view(np.uint16), bf.view(np.uint16))


def test_zarr_refuses_order_f_and_other_compressors(tmp_path):
    root = str(tmp_path)
    data = _values("<f4", (4, 4))
    _zarr_over_ocdbt(root, "f", data, (4, 4), "<f4", order="F").write(data).result()
    _zarr_over_ocdbt(root, "z", data, (4, 4), "<f4", compressor={"id": "zlib", "level": 1}).write(data).result()
    store = OcdbtStore(root)
    with pytest.raises(ZarrError, match="order 'F'"):
        read_array(store, "f")
    with pytest.raises(ZarrError, match="compressor 'zlib' is not read"):
        read_array(store, "z")
    with pytest.raises(ZarrError, match="no .zarray"):
        read_array(store, "absent")


SHAPE, CHUNKS = (37, 23, 3), (16, 10, 2)
REGIONS = [  # per axis: ascending ranges, None for the whole axis
    [None, None, None],
    [[(0, 16)], None, [(1, 3)]],  # one row of chunks; the part of an edge chunk
    [[(5, 21)], [(9, 11)], None],  # across chunk boundaries
    [[(2, 4), (17, 19), (33, 37)], [(0, 3), (20, 23)], [(2, 3)]],  # blocks; partial edge chunks
    [[], None, None],  # an empty part
]


def _indices(ranges, size: int) -> np.ndarray:
    return np.arange(size) if ranges is None else np.array([i for a, b in ranges for i in range(a, b)], np.int64)


@pytest.fixture(scope="module")
def zarr_dtypes(tmp_path_factory):
    """One array of SHAPE per dtype of ZARR_DTYPES, in chunks of CHUNKS."""
    root = tmp_path_factory.mktemp("zarr_regions")
    names = {}
    for i, dtype in enumerate(ZARR_DTYPES):
        data = _values(dtype, SHAPE, seed=i)
        _zarr_over_ocdbt(str(root), f"x{i}", data, CHUNKS, dtype,
                         compressor={"id": "zstd", "level": 5}).write(data).result()
        names[dtype] = f"x{i}"
    yield OcdbtStore(str(root)), names
    shutil.rmtree(root)


@pytest.mark.parametrize("dtype", ZARR_DTYPES)
def test_zarr_regions_are_the_slices_of_a_whole_read(zarr_dtypes, dtype):
    store, names = zarr_dtypes
    whole = read_array(store, names[dtype])
    for region in REGIONS:
        zarr2.CHUNKS.clear()
        got = read_array(store, names[dtype], region)
        ref = whole
        for axis, (ranges, size) in enumerate(zip(region, SHAPE)):
            ref = ref.take(_indices(ranges, size), axis=axis)
        assert got.dtype == whole.dtype and got.shape == ref.shape and got.tobytes() == ref.tobytes(), region
        meets = [{i // c for i in _indices(r, n)} for r, n, c in zip(region, SHAPE, CHUNKS)]
        assert zarr2.CHUNKS[names[dtype]] == math.prod(len(m) for m in meets), region
    with pytest.raises(ZarrError, match="outside an axis of 23"):
        read_array(store, names[dtype], [None, [(20, 24)], None])


# ---------------------------------------------------------------- orbax checkpoints


def _save(log_dir: str, step: int, tree, **save_kw) -> str:
    mgr = jckpt.manager(log_dir)
    if save_kw:
        mgr.save(step, args=ocp.args.StandardSave(tree, **save_kw))
    else:
        jckpt.save(mgr, step, tree)
    mgr.wait_until_finished()
    return os.path.join(log_dir, "checkpoints", str(step))


@pytest.fixture(scope="module")
def small_variables():
    return random_flax_variables(JaxPicoPose(**SMALL, compute_dtype=jnp.float32), seed=3)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory, small_variables):
    """Orbax step directories written by the JAX package: the small
    model's variables, a multi-chunk tree of mixed dtypes, a JAX log dir
    (``version_7/checkpoints/4/``) holding the same variables."""
    d = tmp_path_factory.mktemp("orbax")
    rng = np.random.default_rng(0)
    mixed = {"f4": rng.standard_normal((37, 50)).astype(np.float32), "f8": rng.standard_normal((9, 7)),
             "i8": np.arange(30, dtype=np.int64).reshape(5, 6), "u4": np.arange(12, dtype=np.uint32),
             "u1": np.arange(200, dtype=np.uint8), "b1": rng.random(17) > 0.5,
             "bf": rng.standard_normal((33, 5)).astype(ml_dtypes.bfloat16), "scalar": np.float32(2.5),
             "j": jnp.ones((40, 40)), "nested": ({"a": jnp.arange(6, dtype=jnp.int32)}, [jnp.zeros(3)], None, (), {}, [])}
    save_args = jax.tree.map(lambda _: ocp.SaveArgs(chunk_byte_size=256), mixed)
    log = d / "log" / "picopose" / "version_7"
    paths = {
        "variables": _save(str(d / "variables"), 3, small_variables),
        "mixed": _save(str(d / "mixed"), 1, mixed, save_args=save_args),
        "log": str(log),
    }
    (log / "checkpoints").mkdir(parents=True)
    os.symlink(paths["variables"], log / "checkpoints" / "4")
    yield paths
    shutil.rmtree(d)  # ~0.3 GB


def _assert_trees_equal(got, ref, path=""):
    """The port's tree against the JAX package's restore: containers,
    leaves' dtypes (bf16 as raw bits), shapes and bits."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(ref), path
        for k in ref:
            _assert_trees_equal(got[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert type(got) is type(ref) and len(got) == len(ref), path
        for i, (a, b) in enumerate(zip(got, ref)):
            _assert_trees_equal(a, b, f"{path}/{i}")
    elif ref is None:
        assert got is None, path
    else:
        ref = np.asarray(ref)
        assert isinstance(got, np.ndarray) and got.shape == ref.shape, path
        if ref.dtype == ml_dtypes.bfloat16:
            assert got.dtype.names == ("bf16",), path
            got, ref = got.view(np.uint16), ref.view(np.uint16)
        assert got.dtype == ref.dtype and np.array_equal(got, ref), (path, got.dtype, ref.dtype)


def _ocdbt_equals_tensorstore(root: str):
    kv = tstore.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/"}).result()
    keys = [k.decode() for k in kv.list().result()]
    store = OcdbtStore(root)
    assert store.list() == sorted(keys) and keys
    for k in keys:
        assert store.read(k) == kv.read(k).result().value, k
    return keys


@pytest.mark.parametrize("which", ["variables", "mixed", "train", "fixture"])
def test_ocdbt_list_and_read_equal_tensorstore_on_orbax_checkpoints(ckpts, resume, which):
    step = {"variables": ckpts["variables"], "mixed": ckpts["mixed"], "train": resume[1]["path"],
            "fixture": os.path.join(make_orbax_fixture.OUT, "train", "checkpoints", "5")}[which]
    item = os.path.join(step, "default")
    keys = _ocdbt_equals_tensorstore(item)
    assert any(k.endswith("/.zarray") for k in keys)
    for proc in sorted(n for n in os.listdir(item) if n.startswith("ocdbt.process_")):
        _ocdbt_equals_tensorstore(os.path.join(item, proc))
    if which == "mixed":
        assert len([k for k in keys if k.startswith("f4/")]) > 2  # several chunks


@pytest.mark.parametrize("config", [
    {"max_decoded_node_bytes": 160, "max_inline_value_bytes": 8},  # interior nodes, values out of line
    {"version_tree_arity_log2": 1},  # version tree nodes
    {"compression": None, "max_decoded_node_bytes": 200},
    {"compression": {"id": "zstd", "level": 9}},
])
def test_ocdbt_list_and_read_equal_tensorstore_on_other_stores(tmp_path, config):
    root = str(tmp_path / "kv")
    kv = tstore.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/", "config": config}).result()
    rng = np.random.default_rng(0)
    for i in range(40):
        kv.write(f"key/{i % 7}/{i:04d}", rng.integers(0, 256, int(rng.integers(0, 40)), dtype=np.uint8).tobytes()
                 ).result()
    kv.delete_range(tstore.KvStore.KeyRange("key/3/", "key/4/")).result()
    keys = _ocdbt_equals_tensorstore(root)
    assert not any(k.startswith("key/3/") for k in keys)


def test_corrupt_or_truncated_nodes_and_manifests_raise(tmp_path):
    src = os.path.join(make_orbax_fixture.OUT, "variables", "checkpoints", "3", "default")
    for target in ("manifest.ocdbt", "node", "truncate", "missing"):
        d = tmp_path / target
        shutil.copytree(src, d)
        store = OcdbtStore(str(d))  # whole: reads
        ref = next(v for v in (store.locate(k) for k in store.list()) if not isinstance(v, bytes))
        if target == "manifest.ocdbt":
            path = d / "manifest.ocdbt"
        else:
            path = d / next(f"d/{n}" for n in os.listdir(d / "d"))  # the root's node file
        blob = bytearray(path.read_bytes())
        if target == "missing":
            os.remove(d / ref.path)
            with pytest.raises(OcdbtError, match="data file"):
                OcdbtStore(str(d)).read(next(k for k in store.list() if store.locate(k) == ref))
            continue
        if target == "truncate":
            path.write_bytes(bytes(blob[:-7]))
            match = "bytes at 0 wanted"  # the node reference reaches past the end of the file
        else:
            blob[len(blob) // 2] ^= 0x10
            path.write_bytes(bytes(blob))
            match = "CRC32C mismatch"
        with pytest.raises(OcdbtError, match=match) as e:
            OcdbtStore(str(d))
        assert str(d) in str(e.value)


def test_read_step_dir_equals_the_jax_load_any(ckpts):
    for which in ("variables", "mixed"):
        for path in (ckpts[which], os.path.join(ckpts[which], "default")):  # step dir and item dir
            _assert_trees_equal(read_step_dir(path), jax.tree.map(np.asarray, jckpt.load_any(path)))


def test_load_any_of_a_variables_checkpoint_equals_the_jax_load_any(ckpts, small_variables):
    got = ckpt.load_any(ckpts["variables"])
    _assert_trees_equal(got, jax.tree.map(np.asarray, jckpt.load_any(ckpts["variables"])))
    _assert_trees_equal(got, jax.tree.map(np.asarray, small_variables))


def test_a_directory_that_is_no_orbax_checkpoint_raises_with_its_path(tmp_path):
    (tmp_path / "default").mkdir()
    for reader in (ckpt.load_any, read_step_dir, ckpt.read_weights):
        with pytest.raises(ValueError, match=f"{tmp_path}: not an orbax checkpoint"):
            reader(str(tmp_path))


KW = dict(vit_type=SMALL["vit_type"], blocks_to_take=SMALL["blocks_to_take"], device="cpu", hyp=2,
          n_template_view=6, pnp_iters=16, max_batch=2)


def test_pose_estimator_from_an_orbax_dir_equals_the_variables(ckpts, small_variables, tmp_path):
    tree = write_bop_tree(str(tmp_path), n_views=6)
    frame = np.random.default_rng(0).integers(0, 256, (240, 320, 3), dtype=np.uint8)
    K = np.array([[300.0, 0, 160], [0, 300, 120], [0, 0, 1]])
    dets = [{"obj_id": 1, "bbox": [40, 30, 120, 110]}, {"obj_id": 1, "bbox": [150, 60, 90, 90]}]
    results = []
    for kw in ({"checkpoint": ckpts["variables"]}, {"variables": small_variables}):
        est = PoseEstimator(**kw, compute_dtype="float32", **KW)
        est.register_object(1, tree["template_dir"])
        results.append((est.model.state_dict(), est.estimate(frame, K, dets)))
    (sa, ra), (sb, rb) = results
    assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    for a, b in zip(ra, rb):
        assert np.array_equal(a.R, b.R) and np.array_equal(a.t, b.t) and a.score == b.score


def test_run_test_on_a_jax_log_dir_equals_the_same_variables(ckpts, small_variables, tmp_path, monkeypatch):
    """``--iter 4`` resolves ``version_7/checkpoints/4/`` (a JAX step
    directory); the rows equal those from a torch file of the same
    variables (the JAX package's exporter)."""
    tree = write_bop_tree(str(tmp_path / "tree"), n_views=6)
    monkeypatch.chdir(os.path.dirname(os.path.dirname(os.path.dirname(ckpts["log"]))))
    args = ["--dataset", "fakeds", "--batch", "2", "--device", "cpu", "--view", "6",
            "--config", os.path.join(ROOT, "configs", "base.yaml"),
            "--set", f"test_dataset.data_dir={tree['data_dir']}", f"test_dataset.template_dir={tree['template_root']}",
            f"test_dataset.detection_dir={tree['det_dir']}", f"model.vit_type={SMALL['vit_type']}",
            "model.blocks_to_take=[0,1,2,3]", "model.compute_dtype=float32", "model.hypothesis=2"]
    torch_file = str(tmp_path / "model.ckpt")
    jax_save_torch_checkpoint(small_variables, torch_file)
    (a,) = run_test.main(args + ["--version_id", "7", "--iter", "4"])
    (b,) = run_test.main(args + ["--version_id", "8", "--checkpoint_path", torch_file])
    os.remove(torch_file)
    rows = [[r.split(",")[:6] for r in open(p).read().splitlines()] for p in (a, b)]
    assert rows[0] == rows[1] and len(rows[0]) > 3


def test_export_torch_of_an_orbax_dir_equals_the_jax_tool(ckpts, tmp_path, monkeypatch):
    out = export_torch.main([ckpts["variables"], str(tmp_path / "port.ckpt"), "--depth", "4"])
    _jax_tool([ckpts["variables"], str(tmp_path / "jax.ckpt"), "--depth", "4"])
    got = torch.load(out, weights_only=False)["state_dict"]
    ref = torch.load(str(tmp_path / "jax.ckpt"), weights_only=False)["state_dict"]
    os.remove(out)
    os.remove(tmp_path / "jax.ckpt")
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert torch.equal(torch.as_tensor(got[k]).reshape(-1), torch.as_tensor(ref[k]).reshape(-1)), k


# ---------------------------------------------------------------- training checkpoints


def _jax_run(variables, grad_accum: int, steps: int, log_dir: str):
    """The JAX ``make_train_step`` ``steps`` times from ``variables``, the
    state saved at the end; then the JAX package restores the save and
    takes one more step.  Returns the save's path, the restored state's
    step (losses, state dict, noise) and the state before it."""
    jmodel = JaxPicoPose(**SMALL, compute_dtype=jnp.float32)
    jb = {k: jnp.asarray(v) for k, v in _batch().items()}
    tx = js.make_optimizer(**OPT, grad_accum=grad_accum)
    step = js.make_train_step(jmodel, tx)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = js.TrainState(jnp.zeros((), jnp.int32), params, jax.tree.map(jnp.asarray, variables["batch_stats"]),
                          tx.init(params))
    for i in range(steps):
        state, _ = step(state, jb, jax.random.PRNGKey(20 + i))
    mgr = jckpt.manager(log_dir)
    jckpt.save(mgr, steps, state)
    mgr.wait_until_finished()
    restored = jckpt.restore(mgr, None, jax.tree.map(jnp.zeros_like, state))
    key = jax.random.PRNGKey(20 + steps)
    after, losses = step(restored, jb, key)
    return dict(
        path=os.path.join(log_dir, "checkpoints", str(steps)),
        saved=jax.tree.map(np.asarray, state),
        losses={k: float(v) for k, v in losses.items()},
        after=state_dict_from_flax({"params": after.params, "batch_stats": after.batch_stats}),
        noise=jax_affine_noise(jax.random.split(key)[0], B),
    )


@pytest.fixture(scope="module")
def resume(tmp_path_factory):
    """AdamW after 2 JAX steps (grad_accum 1) and after 3 (grad_accum 2,
    the third step's gradient accumulated), each saved, restored and
    stepped once more by the JAX package."""
    variables = random_flax_variables(JaxPicoPose(**SMALL, compute_dtype=jnp.float32), seed=0)
    d = tmp_path_factory.mktemp("resume")
    yield {1: _jax_run(variables, 1, 2, str(d / "accum1")), 2: _jax_run(variables, 2, 3, str(d / "accum2"))}
    shutil.rmtree(d)  # ~2 GB


def _port_state(grad_accum: int, seed: int = 1):
    return ts.init_state(ts.make_optimizer(**OPT, grad_accum=grad_accum), seed, device="cpu", **SMALL,
                         compute_dtype=torch.float32)


def test_read_step_dir_of_a_train_state_equals_the_jax_load_any(resume):
    for grad_accum in (1, 2):
        path = resume[grad_accum]["path"]
        _assert_trees_equal(read_step_dir(path), jax.tree.map(np.asarray, jckpt.load_any(path)))
        saved = resume[grad_accum]["saved"]
        _assert_trees_equal(ckpt.load_any(path), {"params": saved.params, "batch_stats": saved.batch_stats})


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_a_jax_train_state_resumes_in_the_port(resume, grad_accum):
    """The port's restore of the JAX save is the saved state (parameters,
    statistics, moments, count, step, and mid-accumulation ``mini_step``
    and the gradient) bitwise, every tensor at its address; its next step
    follows the JAX package's next step from its own restore."""
    run = resume[grad_accum]
    saved = run["saved"]
    state = _port_state(grad_accum)
    addresses = [t.data_ptr() for t in (*state.model.parameters(), *state.optimizer.tensors())]
    log_dir = os.path.dirname(os.path.dirname(run["path"]))
    assert ckpt.latest_step(log_dir) == int(saved.step)
    ckpt.restore(log_dir, None, state)
    assert [t.data_ptr() for t in (*state.model.parameters(), *state.optimizer.tensors())] == addresses
    before = state_dict_from_flax({"params": saved.params, "batch_stats": saved.batch_stats})
    sd = state.model.state_dict()
    assert sorted(sd) == sorted(before) and all(np.array_equal(sd[k].numpy(), before[k]) for k in sd)
    opt = saved.opt_state.inner_opt_state if grad_accum > 1 else saved.opt_state
    names = [n for n, _ in state.model.named_parameters()]
    for name, tree in (("exp_avg", opt[0].mu), ("exp_avg_sq", opt[0].nu)):
        ref = state_dict_from_flax({"params": tree, "batch_stats": saved.batch_stats})
        assert all(np.array_equal(t.numpy(), ref[n]) for n, t in zip(names, state.optimizer.moments[name])), name
    o, count = state.optimizer, int(opt[0].count)
    assert state.step == int(saved.step) and o.updates == int(o.count) == count == {1: 2, 2: 1}[grad_accum]
    if grad_accum > 1:
        assert o.mini_step == int(saved.opt_state.mini_step) == 1
        acc = state_dict_from_flax({"params": saved.opt_state.acc_grads, "batch_stats": saved.batch_stats})
        assert all(np.array_equal(g.numpy(), acc[n]) for n, g in zip(names, o.grads))
    else:
        assert o.mini_step == 0 and not any(bool(g.any()) for g in o.grads)

    losses = ts.make_train_step(state)(state, _batch(), run["noise"])
    for k, v in losses.items():
        np.testing.assert_allclose(float(v), run["losses"][k], rtol=1e-4, err_msg=k)
    after = {k: v.numpy() for k, v in state.model.state_dict().items()}
    delta = lambda s: {k: s[k] - before[k] for k in run["after"]}
    rel = _rel_rms_by_group(delta(after), delta(run["after"]))
    assert max(rel.values()) <= 1e-2, rel
    for n in names:
        np.testing.assert_allclose(after[n], run["after"][n], atol=2 * OPT["base_lr"], rtol=0, err_msg=n)
    assert o.updates == count + 1 and o.mini_step == 0


def test_restore_refuses_another_optimizer_and_another_accumulation(resume):
    log_dir = os.path.dirname(os.path.dirname(resume[1]["path"]))
    state = ts.init_state(ts.make_optimizer(**OPT, opt_type="SGD"), 1, device="cpu", **SMALL,
                          compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="not SGD's"):
        ckpt.restore(log_dir, None, state)
    with pytest.raises(ValueError, match="grad_accum 2"):
        ckpt.restore(log_dir, None, _port_state(2))


def test_latest_step_counts_both_kinds_and_a_pt_wins_its_step(resume, tmp_path):
    log_dir = str(tmp_path)
    os.makedirs(os.path.join(log_dir, "checkpoints"))
    os.symlink(resume[1]["path"], os.path.join(log_dir, "checkpoints", "2"))
    assert ckpt.saved_steps(log_dir) == {2} and ckpt.latest_step(log_dir) == 2
    state = _port_state(1, seed=4)
    path = ckpt.save(log_dir, 2, state, epoch=0)  # the port's save of the same step
    assert ckpt.step_path(log_dir, 2) == path
    other = _port_state(1, seed=5)
    ckpt.restore(log_dir, None, other)  # the .pt
    sa, sb = state.model.state_dict(), other.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    os.makedirs(os.path.join(log_dir, "checkpoints", "1"))
    assert ckpt.latest_step(log_dir) == 2
    os.remove(path)


def test_warm_start_from_jax_step_directories(ckpts, resume, small_variables):
    for path, variables in ((ckpts["variables"], small_variables),
                            (resume[1]["path"], {"params": resume[1]["saved"].params,
                                                 "batch_stats": resume[1]["saved"].batch_stats})):
        state = _port_state(1, seed=6)
        T.warm_start(state, path)
        ref = state_dict_from_flax(jax.tree.map(np.asarray, variables))
        sd = state.model.state_dict()
        assert all(np.array_equal(sd[k].numpy(), ref[k]) for k in sd)
        assert state.step == 0 and state.optimizer.updates == 0


def test_run_training_resumes_a_jax_log_dir(resume, tmp_path, monkeypatch):
    """``run_training(resume=True)`` on a log dir of the JAX package's
    (its ``checkpoints/2/``): the loop restores the JAX state and goes on
    from its step (the step itself a stand-in here; the real one is the
    test above)."""
    mp = write_megapose_tree(str(tmp_path / "mp"))
    log_dir = str(tmp_path / "log")
    os.makedirs(os.path.join(log_dir, "checkpoints"))
    os.symlink(resume[1]["path"], os.path.join(log_dir, "checkpoints", "2"))
    seen = []

    def steps(state):
        def step(state, batch, noise):
            if not seen:
                seen.append((state.step, {k: v.clone() for k, v in state.model.state_dict().items()}))
            state.step += 1
            return {"loss": torch.tensor(0.0)}
        from picopose_tpu_torch.utils.graphs import GraphCache
        step.graphs = GraphCache("cpu")
        return step

    monkeypatch.setattr(T, "make_train_step", steps)
    monkeypatch.setattr(T.ckpt, "save", lambda *a, **k: None)
    cfg = load_config(os.path.join(ROOT, "configs", "base.yaml"), [
        f"train_dataset.data_dir={mp}", "train_dataset.min_px_count_visib=100", "trainer.training_epoch=2",
        "lr_scheduler.max_iters=4", "lr_scheduler.warmup_iters=2", "trainer.iters_to_print=1",
        "train_dataloader.bs=1", "train_dataloader.num_workers=1", "train_dataloader.backend=threads",
        "model.vit_type=vit_tiny_test", "model.blocks_to_take=[0,1,2,3]", "model.compute_dtype=float32"])
    T.run_training(cfg, log_dir, resume=True, max_steps=3, device="cpu")
    step, sd = seen[0]
    saved = resume[1]["saved"]
    ref = state_dict_from_flax({"params": saved.params, "batch_stats": saved.batch_stats})
    assert step == 2 and all(np.array_equal(sd[k].numpy(), ref[k]) for k in sd)


# ---------------------------------------------------------------- the committed fixture


def test_the_committed_fixture_reads_as_the_script_writes_it():
    """tests/data/orbax_small/ against tests/make_orbax_fixture.py: every
    leaf of both step directories as the script draws it (the port and
    the JAX package read the same), the companion .npz the script's tiles,
    and the directory under 3 MB."""
    out = make_orbax_fixture.OUT
    tiles = make_orbax_fixture.tiles(0)
    with np.load(os.path.join(out, "leaves.npz")) as z:
        assert sorted(z.files) == sorted([f"tile/{p}" for p in tiles] + [f"shape/{p}" for p in tiles])
        for p, (tile, shape) in tiles.items():
            assert np.array_equal(z[f"tile/{p}"], tile) and z[f"tile/{p}"].dtype == tile.dtype
            assert tuple(z[f"shape/{p}"]) == shape
    train = read_step_dir(os.path.join(out, "train", "checkpoints", "5"))
    for p, (tile, shape) in tiles.items():
        node = train
        for k in p.split("/"):
            node = node[int(k)] if isinstance(node, list) else node[k]
        ref = make_orbax_fixture.expand(tile, shape)
        assert node.dtype == ref.dtype and node.shape == ref.shape and np.array_equal(node, ref), p
    variables = ckpt.load_any(os.path.join(out, "variables", "checkpoints", "3"))
    _assert_trees_equal(variables, {"params": train["params"], "batch_stats": train["batch_stats"]})
    _assert_trees_equal(train, jax.tree.map(np.asarray, jckpt.load_any(os.path.join(out, "train", "checkpoints", "5"))))
    total = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(out) for f in fs)
    assert total < 3 * 1024 * 1024, total


SHARDED_TRAIN = os.path.join(make_orbax_fixture.OUT_SHARDED, "train", "checkpoints", "5")


def _leaf_at(tree, path: str):
    for k in path.split("/"):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def test_the_sharded_fixture_is_two_processes_save_of_the_small_ones_state():
    """tests/data/orbax_sharded/ against the script's tiles and, leaf for
    leaf, bitwise orbax_small's TrainState; both processes' stores hold
    chunks, split leaves are stored as a chunk per shard over both mesh
    axes; under 3 MB.  (The JAX package's ``load_any`` does not read it in
    one process: orbax asks for the four devices it was saved from.)"""
    tiles = make_orbax_fixture.tiles(0)
    got = read_step_dir(SHARDED_TRAIN)
    small = read_step_dir(os.path.join(make_orbax_fixture.OUT, "train", "checkpoints", "5"))
    _assert_trees_equal(got, small)
    for p, (tile, shape) in tiles.items():
        node, ref = _leaf_at(got, p), make_orbax_fixture.expand(tile, shape)
        assert node.dtype == ref.dtype and node.shape == ref.shape and node.tobytes() == ref.tobytes(), p
    store = OcdbtStore(os.path.join(SHARDED_TRAIN, "default"))
    stores = {store.locate(k).path.split("/")[0] for k in store.list() if isinstance(store.locate(k), Ref)}
    assert {"ocdbt.process_0", "ocdbt.process_1"} <= stores
    assert any(f.startswith("ocdbt.process_1/d/") for f in
               (os.path.relpath(os.path.join(d, f), os.path.join(SHARDED_TRAIN, "default"))
                for d, _, fs in os.walk(os.path.join(SHARDED_TRAIN, "default", "ocdbt.process_1")) for f in fs))
    for name in ("params.affine_regressor.fc1.kernel", "params.feature_extractor.dinov2.blocks_0.attn.qkv.kernel"):
        meta = json.loads(store.read(f"{name}/.zarray"))  # fsdp over 'data' on axis 0, tp over 'model' on axis 1
        assert [s // c for s, c in zip(meta["shape"], meta["chunks"])] == list(make_orbax_fixture.MESH), name
        assert all(f"{name}/{i}.{j}" in store for i in range(2) for j in range(2)), name
    total = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(make_orbax_fixture.OUT_SHARDED) for f in fs)
    assert total < 3 * 1024 * 1024, total


def test_a_corrupt_chunk_in_a_process_store_raises_naming_its_file(tmp_path):
    dst = str(tmp_path / "5")
    shutil.copytree(SHARDED_TRAIN, dst)
    store = OcdbtStore(os.path.join(dst, "default"))
    key, ref = next((k, store.locate(k)) for k in store.list()
                    if isinstance(store.locate(k), Ref) and store.locate(k).path.startswith("ocdbt.process_1/")
                    and not k.endswith(".zarray"))
    path = os.path.join(dst, "default", ref.path)
    with open(path, "r+b") as f:  # the chunk's zstd magic number
        f.seek(ref.offset)
        f.write(bytes(4))
    with pytest.raises(ZarrError, match=re.escape(f"chunk {key} in {path}")):
        read_step_dir(dst)


FSDP2 = ("fsdp", 2, 1)
FSDP2_RANK = 1  # data rank 1: its part of each split leaf, and none of a replicated leaf's accumulated gradient


@pytest.fixture(scope="module")
def fsdp2_parts():
    """The one-process restore of orbax_sharded (and the bytes it
    decodes), the chunks of each of its leaves, and at ``FSDP2_RANK`` of
    fsdp over 2 the chunks of each split params leaf that meet its part:
    the port's weight conversion (utils/weights.py) applied to leaves of
    their flat indices (as two fp32 halves, each exact below 2^24), the
    rank's part cut by ``shard_of``, and the chunks of the indices in it."""
    one = _port_state(2)
    zarr2.CHUNK_BYTES.clear()
    ckpt.restore(os.path.dirname(os.path.dirname(SHARDED_TRAIN)), None, one)
    whole = sum(zarr2.CHUNK_BYTES.values())
    store = OcdbtStore(os.path.join(SHARDED_TRAIN, "default"))
    chunks = collections.Counter(k.rsplit("/", 1)[0] for k in store.list() if not k.endswith(".zarray"))
    tree = read_step_dir(SHARDED_TRAIN, top=("params", "batch_stats"))
    index = lambda f: jax.tree.map(lambda a: f(np.arange(a.size, dtype=np.int64).reshape(a.shape)).astype(np.float32),
                                   tree)
    hi, lo = (state_dict_from_flax(index(f)) for f in (lambda i: i >> 12, lambda i: i & 4095))
    mesh = Mesh(FSDP2[1], FSDP2[2], FSDP2_RANK, torch.device("cpu"))
    shardings = state_shardings(mesh, one, FSDP2[0])
    meets = {}
    for name, p in one.model.named_parameters():
        path, _ = flax_leaf(one.model, name, p.ndim)
        leaf, key, spec = path.replace("/", "."), path[len("params/"):], shardings.param(name)
        if not spec.split:  # the whole leaf
            meets[key] = (chunks[leaf], False)
            continue
        meta = json.loads(store.read(f"{leaf}/.zarray"))
        grid = [-(-n // c) for n, c in zip(meta["shape"], meta["chunks"])]
        h, l = (shard_of(torch.from_numpy(np.ascontiguousarray(d[name])), spec, mesh).numpy().astype(np.int64).ravel()
                for d in (hi, lo))
        ids = [i // c for i, c in zip(np.unravel_index((h << 12) + l, meta["shape"]), meta["chunks"])]
        hit = np.bincount(np.ravel_multi_index(ids, grid), minlength=math.prod(grid)) > 0
        meets[key] = (int(hit.sum()), spec.data is not None)
    return one, whole, chunks, meets


def test_a_rank_decodes_only_the_chunks_that_meet_its_part(fsdp2_parts):
    """``restore`` under fsdp over 2 at ``FSDP2_RANK``: each params leaf and its
    ``mu``, ``nu`` and ``acc_grads`` decode the chunks that meet the
    rank's part (none of an accumulated gradient off data rank 0 that is
    not split over 'data'), every other leaf all of its chunks; the
    rank's tensors are bitwise its part of the one-process restore."""
    one, whole, chunks, meets = fsdp2_parts
    mesh = Mesh(FSDP2[1], FSDP2[2], FSDP2_RANK, torch.device("cpu"))
    state = shard_state(_port_state(2, seed=7), mesh, FSDP2[0])
    zarr2.CHUNKS.clear()
    zarr2.CHUNK_BYTES.clear()
    ckpt.restore(os.path.dirname(os.path.dirname(SHARDED_TRAIN)), None, state)
    fewer = 0
    for name, total in chunks.items():
        keys = name.split(".")
        at = {"params": 0, "opt_state": next((i for i, k in enumerate(keys) if k in ("mu", "nu", "acc_grads")), None)
              }.get(keys[0])
        if at is None:
            assert zarr2.CHUNKS[name] == total, name
            continue
        n, data_split = meets["/".join(keys[at + 1:])]
        if keys[at] == "acc_grads" and not data_split:  # data rank 0 alone holds it
            n = 0
        assert zarr2.CHUNKS[name] == n, (name, zarr2.CHUNKS[name], n, total)
        fewer += n < total
    assert fewer > 100 and sum(zarr2.CHUNK_BYTES.values()) < 0.55 * whole

    layout, full = state.layout, one.model.state_dict()
    for name, spec, t in zip(layout.names, layout.specs, layout.local):
        assert torch.equal(t, shard_of(full[name], spec, mesh)), name
    for name, b in state.model.named_buffers():
        assert torch.equal(b, full[name]), name
    ref, got = local_optimizer_state(one.optimizer.state_dict(), layout.specs, mesh), state.optimizer.state_dict()
    for i, m in ref["optimizer"]["state"].items():
        assert all(torch.equal(got["optimizer"]["state"][i][k], v) for k, v in m.items()), i
    assert all(torch.equal(a, b) for a, b in zip(got["grads"], ref["grads"]))
    assert (state.step, got["scheduler"], got["mini_step"]) == (one.step, ref["scheduler"], ref["mini_step"]) == (
        5, {"last_epoch": 2}, 1)
