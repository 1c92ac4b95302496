"""One zarr v2 array read from a key-value store: how an orbax checkpoint
stores each leaf under its OCDBT store (utils/ocdbt.py), as
``<name>/.zarray`` (the array's JSON metadata) and one key per chunk,
``<name>/<i>.<j>...`` (``<name>/0`` for a 0-d array).

What is read: ``order`` "C" (an "F" array raises), ``filters`` null, the
compressor ``zstd`` (native/codec.py) or null (any other raises, naming
it), the ``.`` or ``/`` dimension separator, partial chunks at the edges
(zarr stores them whole), and ``fill_value`` for chunks that are absent
(null reads as zero, as tensorstore reads it).  Dtypes: numpy's bool,
integer and float types in either byte order (``<f4``, ``<f8``, ``<i4``,
``<i8``, ``<u4``, ``|u1``, ``|b1``, ...) and ``bfloat16``, which numpy
lacks: it comes back as its raw bits under ``BF16_TAG``, the form of the
port's ``.npz`` banks, which utils/weights.py widens to fp32.

A ``region`` reads a part of the array and decodes only the chunks that
meet it: per axis, the ranges ``(start, stop)`` of the indices wanted,
ascending and disjoint (None: the whole axis), the part being those
indices in order on every axis (a rank's shard of a leaf, whose model
axis may take a piece of each of several blocks:
parallel/shardings.py::shard_of).  ``CHUNKS`` counts, per array name, the
chunks decoded, and ``CHUNK_BYTES`` their decoded bytes; a caller sets
them to zero before a read and reads them after.
"""

from __future__ import annotations

import collections
import itertools
import json
import math
import os
import threading
from typing import Sequence

import numpy as np

from picopose_tpu_torch.native.codec import ZstdError, zstd_decompress
from picopose_tpu_torch.utils.weights import BF16_TAG, f32_to_bf16_bits


class ZarrError(ValueError):
    """An array this reader does not read, or a malformed one."""


Region = Sequence[Sequence[tuple[int, int]] | None]

CHUNKS: collections.Counter = collections.Counter()
CHUNK_BYTES: collections.Counter = collections.Counter()
_count_lock = threading.Lock()


def _dtype(name: str, where: str) -> np.dtype:
    if name == "bfloat16":
        return np.dtype(np.uint16)
    try:
        dt = np.dtype(name)
    except TypeError:
        dt = None
    if dt is None or dt.kind not in "biuf":
        raise ZarrError(f"{where}: dtype {name!r} is not read (bool, integer, float and bfloat16 are)")
    return dt


def _fill(meta: dict, dt: np.dtype, bf16: bool):
    v = meta.get("fill_value")
    if v is None:
        return 0
    if isinstance(v, str):  # JSON has no NaN or infinities
        v = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}.get(v, v)
    if bf16:
        return f32_to_bf16_bits(np.float32(v))
    return dt.type(v)


def _pieces(ranges, size: int, chunk: int) -> dict[int, list[tuple[slice, slice]]]:
    """chunk index -> [(slice of the chunk, slice of the part)] along one
    axis of ``size`` in chunks of ``chunk``, for the part ``ranges``."""
    out: dict[int, list[tuple[slice, slice]]] = {}
    at = 0
    for start, stop in ranges:
        if not 0 <= start <= stop <= size:
            raise ZarrError(f"range {(start, stop)} outside an axis of {size}")
        for i in range(start // chunk, -(-stop // chunk)):
            lo, hi = max(start, i * chunk), min(stop, (i + 1) * chunk)
            piece = (slice(lo - i * chunk, hi - i * chunk), slice(at + lo - start, at + hi - start))
            out.setdefault(i, []).append(piece)
        at += stop - start
    return out


def read_array(store, name: str, region: Region | None = None) -> np.ndarray:
    """The array at key prefix ``name`` of ``store`` (anything with
    ``read(key)`` and ``in``, as ocdbt.OcdbtStore), or its part ``region``."""
    where = f"{getattr(store, 'root', store)}: {name}"
    try:
        meta = json.loads(store.read(f"{name}/.zarray"))
    except KeyError:
        raise ZarrError(f"{where}: no .zarray (not a zarr v2 array)") from None
    if meta.get("zarr_format") != 2:
        raise ZarrError(f"{where}: zarr_format {meta.get('zarr_format')!r}, only 2 is read")
    if meta.get("order", "C") != "C":
        raise ZarrError(f"{where}: order {meta.get('order')!r}, only 'C' is read")
    if meta.get("filters"):
        raise ZarrError(f"{where}: filters {meta['filters']!r} are not read")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ZarrError(f"{where}: compressor {comp.get('id')!r} is not read (zstd and none are)")
    bf16 = meta["dtype"] == "bfloat16"
    dt = _dtype(meta["dtype"], where)
    shape, chunks = tuple(int(s) for s in meta["shape"]), tuple(int(c) for c in meta["chunks"])
    if len(shape) != len(chunks) or any(c <= 0 for c in chunks):
        raise ZarrError(f"{where}: chunks {chunks} for shape {shape}")
    region = [None] * len(shape) if region is None else list(region)
    if len(region) != len(shape):
        raise ZarrError(f"{where}: a region of {len(region)} axes for shape {shape}")
    ranges = [[(0, s)] if r is None else list(r) for r, s in zip(region, shape)]
    try:
        axes = [_pieces(r, s, c) for r, s, c in zip(ranges, shape, chunks)]
    except ZarrError as e:
        raise ZarrError(f"{where}: {e}") from None
    sep = meta.get("dimension_separator", ".")
    chunk_bytes = math.prod(chunks) * dt.itemsize
    out = np.empty(tuple(sum(b - a for a, b in r) for r in ranges), dt)
    whole = out.shape == shape
    decoded = 0
    for idx in itertools.product(*(sorted(a) for a in axes)):
        key = f"{name}/{sep.join(str(i) for i in idx) if idx else '0'}"
        pieces = list(itertools.product(*(a[i] for a, i in zip(axes, idx))))
        if key not in store:
            for piece in pieces:
                out[tuple(p for _, p in piece)] = _fill(meta, dt, bf16)
            continue
        # one chunk that is the whole array decodes straight into it
        direct = whole and len(pieces) == 1 and out.size * dt.itemsize == chunk_bytes
        raw = store.read(key)
        decoded += 1
        if comp is None:
            if len(raw) != chunk_bytes:
                raise ZarrError(f"{where}: chunk {key} holds {len(raw)} bytes, {chunk_bytes} expected")
            data = np.frombuffer(raw, np.uint8)
        else:
            try:
                data = zstd_decompress(raw, chunk_bytes, out=out.reshape(-1).view(np.uint8) if direct else None)
            except ZstdError as e:
                raise ZarrError(f"{where}: chunk {key}{_stored_in(store, key)}: {e}") from None
            if data.size != chunk_bytes:
                raise ZarrError(f"{where}: chunk {key} decodes to {data.size} bytes, {chunk_bytes} expected")
        if direct and comp is not None:
            continue
        block = data.view(dt).reshape(chunks)
        for piece in pieces:
            out[tuple(p for _, p in piece)] = block[tuple(c for c, _ in piece)]
    if decoded:
        with _count_lock:
            CHUNKS[name] += decoded
            CHUNK_BYTES[name] += decoded * chunk_bytes
    if dt.byteorder == ">":
        out = out.astype(dt.newbyteorder("="))
    return out.view(BF16_TAG) if bf16 else out


def _stored_in(store, key: str) -> str:
    """`` in <data file>`` for a chunk stored out of line, else ``""``."""
    ref = store.locate(key) if hasattr(store, "locate") else None
    return f" in {os.path.join(store.root, ref.path)}" if hasattr(ref, "path") else ""
