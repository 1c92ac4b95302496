"""A read-only OCDBT key-value store: the on-disk format tensorstore writes
under an orbax checkpoint's item directory (``manifest.ocdbt``, ``d/``,
``ocdbt.process_<i>/``).

The JAX package reads it through tensorstore; the port reads it here, with
the zstd decoder and CRC32C of the host library (native/codec.py).

The format, as tensorstore 0.1.80 writes it:

* Every manifest and B-tree node is ``magic`` (uint32 big-endian:
  0x0cdb3a2a manifest, 0x0cdb20de node), ``length`` (uint64 LE, the
  whole encoding), ``version`` (varint, 0), ``compression`` (varint: 0
  none, 1 one zstd frame), the body, and a CRC32C (uint32 LE) of all the
  bytes before it.  Integers in a body are LEB128 varints unless stated.
* A manifest body: the config (uuid, 16 bytes; manifest kind; max inline
  value bytes; max decoded node bytes; version tree arity log2, one byte;
  compression 0, or 1 and the zstd level as int32 LE), then, for a
  manifest of kind "single", the newest leaf of the version tree: a data
  file table, the number of versions, and per version, column by column,
  generation, root height (byte), root data file, offset, length, key
  count, tree bytes, indirect value bytes and commit time (uint64 LE);
  then the references to older version tree nodes, column by column:
  generation, data file, offset, length, generation count, commit time
  (uint64 LE), height (byte).  The newest version is the last one.
* A data file table: the number of files, for each file after the first
  the length of the path prefix it shares with the one before, then each
  path's suffix length, then each base path's length, then the suffixes.
  A path is ``base_path + relative_path`` under the store's directory
  (``ocdbt.process_0/`` + ``d/<hash>`` for the per-process stores an
  orbax save merges into its root).
* A B-tree node body: height (byte), a data file table, the number of
  entries, each key's length shared with the previous key (after the
  first), each key's suffix length, for an interior node each child's
  common prefix length, the key suffixes; a leaf then gives every value's
  length, every value's kind (byte: 0 inline, 1 in a data file), the data
  file and then the offset of each value stored out of line, and the
  inline values back to back; an interior node gives each child's data
  file, offset, length, key count, tree bytes and indirect value bytes.
  Keys are relative to the node's prefix: the parent's prefix plus the
  first ``common prefix length`` bytes of the child's entry key.

Every node and manifest checksum is verified; a malformed or truncated
file raises ``OcdbtError`` with its path and byte offset.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np

from picopose_tpu_torch.native.codec import ZstdError, crc32c, zstd_decompress

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MANIFEST_NAME = "manifest.ocdbt"


class OcdbtError(ValueError):
    """A malformed or unsupported OCDBT store."""


@dataclass(frozen=True)
class Ref:
    """A byte range of a data file: ``path`` relative to the store."""

    path: str
    offset: int
    length: int


class _Reader:
    """Sequential reads of one decoded body, with errors that name it."""

    def __init__(self, data: bytes, what: str):
        self.b, self.i, self.what = data, 0, what

    def fail(self, msg: str):
        raise OcdbtError(f"{self.what}: byte {self.i} of the decoded body: {msg}")

    def byte(self) -> int:
        if self.i >= len(self.b):
            self.fail("truncated")
        self.i += 1
        return self.b[self.i - 1]

    def raw(self, n: int) -> bytes:
        if self.i + n > len(self.b):
            self.fail(f"truncated ({n} bytes wanted)")
        self.i += n
        return self.b[self.i - n:self.i]

    def varint(self) -> int:
        v = shift = 0
        while True:
            c = self.byte()
            v |= (c & 0x7F) << shift
            if c < 0x80:
                return v
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def u64s(self, n: int) -> list[int]:
        return list(struct.unpack(f"<{n}Q", self.raw(8 * n)))

    def count(self, limit: int = 1 << 24) -> int:
        n = self.varint()
        if n > limit:
            self.fail(f"count {n} out of range")
        return n

    def data_files(self) -> list[str]:
        n = self.count()
        prefix = [0] + self.varints(n - 1) if n else []
        suffix = self.varints(n)
        base = self.varints(n)
        paths, prev = [], b""
        for k in range(n):
            if prefix[k] > len(prev):
                self.fail("data file path prefix longer than the path before it")
            cur = prev[:prefix[k]] + self.raw(suffix[k])
            if base[k] > len(cur):
                self.fail("data file base path longer than the path")
            paths.append(cur.decode())
            prev = cur
        return paths

    def file_index(self, files: list[str]) -> int:
        i = self.varint()
        if i >= len(files):
            self.fail(f"data file {i} of a table of {len(files)}")
        return i


def _decode(blob: bytes, magic: int, what: str, limit: int) -> bytes:
    """Check a manifest's or node's header and checksum; returns its body."""
    if len(blob) < 18:
        raise OcdbtError(f"{what}: {len(blob)} bytes, shorter than a header and checksum")
    got_magic, length = struct.unpack(">I", blob[:4])[0], struct.unpack("<Q", blob[4:12])[0]
    if got_magic != magic:
        raise OcdbtError(f"{what}: magic {got_magic:#010x}, expected {magic:#010x}")
    if length != len(blob):
        raise OcdbtError(f"{what}: header says {length} bytes, {len(blob)} present")
    crc = struct.unpack("<I", blob[-4:])[0]
    if crc32c(np.frombuffer(blob, np.uint8, len(blob) - 4)) != crc:
        raise OcdbtError(f"{what}: CRC32C mismatch (stored {crc:#010x})")
    r = _Reader(blob, what)
    r.i = 12
    version, compression = r.varint(), r.varint()
    if version != 0:
        raise OcdbtError(f"{what}: format version {version}, only 0 is known")
    body = blob[r.i:-4]
    if compression == 0:
        return body
    if compression != 1:
        raise OcdbtError(f"{what}: compression {compression}, only 0 (none) and 1 (zstd) are known")
    try:
        return zstd_decompress(body, limit).tobytes()
    except ZstdError as e:
        raise OcdbtError(f"{what}: {e} (after the {r.i}-byte header)") from None


class OcdbtStore:
    """The newest version of the OCDBT store in ``root`` (a directory that
    holds ``manifest.ocdbt``): ``list()`` its keys, ``read(key)`` a value."""

    def __init__(self, root: str):
        self.root = root
        path = os.path.join(root, MANIFEST_NAME)
        if not os.path.isfile(path):
            raise OcdbtError(f"{root}: no {MANIFEST_NAME} (not an OCDBT store)")
        with open(path, "rb") as f:
            blob = f.read()
        self._entries: dict[bytes, bytes | Ref] = {}
        self._read_manifest(blob, path)

    # ---- manifest and version tree --------------------------------------------

    def _read_manifest(self, blob: bytes, what: str) -> None:
        r = _Reader(_decode(blob, MANIFEST_MAGIC, what, 1 << 30), what)
        r.raw(16)  # uuid
        kind = r.varint()
        r.varint()  # max inline value bytes
        self.max_node_bytes = r.varint()
        r.byte()  # version tree arity log2
        compression = r.varint()
        if compression == 1:
            r.raw(4)  # zstd level, int32 LE
        elif compression != 0:
            r.fail(f"compression method {compression}")
        if kind != 0:
            r.fail(f"manifest kind {kind}: only 'single' (0), the kind orbax writes, is read")
        files = r.data_files()
        n = r.count()
        if n == 0:
            return  # an empty store
        r.varints(n)  # generations
        heights = list(r.raw(n))
        ids = [r.file_index(files) for _ in range(n)]
        offsets, lengths = r.varints(n), r.varints(n)
        r.varints(3 * n)  # key counts, tree bytes, indirect value bytes
        r.u64s(n)  # commit times
        m = r.count()  # older version tree nodes: parsed, not followed
        r.varints(m)
        [r.file_index(files) for _ in range(m)]
        r.varints(3 * m)
        r.u64s(m)
        r.raw(m)
        if r.i != len(r.b):
            r.fail(f"{len(r.b) - r.i} bytes after the version tree")
        if lengths[-1] == 0:
            return  # the newest version is empty
        self._walk(Ref(files[ids[-1]], offsets[-1], lengths[-1]), heights[-1], b"")

    # ---- B-tree ---------------------------------------------------------------

    def _read_range(self, ref: Ref) -> bytes:
        path = os.path.join(self.root, ref.path)
        try:
            with open(path, "rb") as f:
                f.seek(ref.offset)
                data = f.read(ref.length)
        except OSError as e:
            raise OcdbtError(f"{self.root}: data file {ref.path}: {e}") from None
        if len(data) != ref.length:
            raise OcdbtError(f"{path}: {ref.length} bytes at {ref.offset} wanted, {len(data)} present")
        return data

    def _walk(self, ref: Ref, height: int, prefix: bytes) -> None:
        what = f"{os.path.join(self.root, ref.path)} node at {ref.offset}"
        r = _Reader(_decode(self._read_range(ref), NODE_MAGIC, what, self.max_node_bytes), what)
        got = r.byte()
        if got != height:
            r.fail(f"height {got}, its parent says {height}")
        files = r.data_files()
        n = r.count()
        shared = [0] + r.varints(n - 1) if n else []
        suffix = r.varints(n)
        common = r.varints(n) if height else []
        keys, prev = [], b""
        for k in range(n):
            if shared[k] > len(prev):
                r.fail("key prefix longer than the key before it")
            prev = prev[:shared[k]] + r.raw(suffix[k])
            keys.append(prev)
        if height:
            ids = [r.file_index(files) for _ in range(n)]
            offsets, lengths = r.varints(n), r.varints(n)
            r.varints(3 * n)  # key counts, tree bytes, indirect value bytes
            if r.i != len(r.b):
                r.fail(f"{len(r.b) - r.i} bytes after the entries")
            for k in range(n):
                if common[k] > len(keys[k]):
                    r.fail("child common prefix longer than its key")
                self._walk(Ref(files[ids[k]], offsets[k], lengths[k]), height - 1, prefix + keys[k][:common[k]])
            return
        lengths = r.varints(n)
        kinds = list(r.raw(n))
        if any(k > 1 for k in kinds):
            r.fail(f"value kind {max(kinds)}")
        indirect = [k for k in range(n) if kinds[k]]
        ids = [r.file_index(files) for _ in indirect]
        offsets = r.varints(len(indirect))
        where = dict(zip(indirect, zip(ids, offsets)))
        for k in range(n):
            if kinds[k]:
                fid, off = where[k]
                self._entries[prefix + keys[k]] = Ref(files[fid], off, lengths[k])
            else:
                self._entries[prefix + keys[k]] = r.raw(lengths[k])
        if r.i != len(r.b):
            r.fail(f"{len(r.b) - r.i} bytes after the values")

    # ---- the store's interface ------------------------------------------------

    def list(self) -> list[str]:
        """Every key, sorted."""
        return sorted(k.decode() for k in self._entries)

    def __contains__(self, key: str | bytes) -> bool:
        return (key.encode() if isinstance(key, str) else key) in self._entries

    def locate(self, key: str | bytes) -> bytes | Ref:
        """A key's value if it is stored inline, else where it is."""
        k = key.encode() if isinstance(key, str) else key
        try:
            return self._entries[k]
        except KeyError:
            raise KeyError(f"{self.root}: no key {k.decode(errors='replace')!r}") from None

    def read(self, key: str | bytes) -> bytes:
        """A key's value; KeyError when it is absent."""
        v = self.locate(key)
        return v if isinstance(v, bytes) else self._read_range(v)
