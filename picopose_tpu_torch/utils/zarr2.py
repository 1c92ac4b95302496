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
"""

from __future__ import annotations

import itertools
import json
import math

import numpy as np

from picopose_tpu_torch.native.codec import zstd_decompress
from picopose_tpu_torch.utils.weights import BF16_TAG, f32_to_bf16_bits


class ZarrError(ValueError):
    """An array this reader does not read, or a malformed one."""


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


def read_array(store, name: str) -> np.ndarray:
    """The array at key prefix ``name`` of ``store`` (anything with
    ``read(key)`` and ``in``, as ocdbt.OcdbtStore)."""
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
    sep = meta.get("dimension_separator", ".")
    chunk_bytes = math.prod(chunks) * dt.itemsize
    out = np.empty(shape, dt)
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        key = f"{name}/{sep.join(str(i) for i in idx) if idx else '0'}"
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        if key not in store:
            out[region] = _fill(meta, dt, bf16)
            continue
        # one chunk that is the whole array decodes straight into it
        direct = all(len(g) == 1 for g in grid) and out.size * dt.itemsize == chunk_bytes
        raw = store.read(key)
        if comp is None:
            if len(raw) != chunk_bytes:
                raise ZarrError(f"{where}: chunk {key} holds {len(raw)} bytes, {chunk_bytes} expected")
            data = np.frombuffer(raw, np.uint8)
        else:
            data = zstd_decompress(raw, chunk_bytes, out=out.reshape(-1).view(np.uint8) if direct else None)
            if data.size != chunk_bytes:
                raise ZarrError(f"{where}: chunk {key} decodes to {data.size} bytes, {chunk_bytes} expected")
        if direct and comp is not None:
            continue
        block = data.view(dt).reshape(chunks)
        out[region] = block[tuple(slice(0, r.stop - r.start) for r in region)]
    if dt.byteorder == ">":
        out = out.astype(dt.newbyteorder("="))
    return out.view(BF16_TAG) if bf16 else out
