"""The port's host library: C++ for the host data path and the template
rasterizer, bound with ctypes.

The counterpart of the JAX package's native layer: ``csrc/fastpath.cpp``
(RLE decode, mask box, crop / resize / normalise, mask crop) and
``csrc/rasterizer.cpp`` (the software template renderer), the port's own
copies of those sources, and ``csrc/zstd.cpp`` (the zstd decoder and the
CRC32C of the orbax checkpoint reader, native/codec.py), which the JAX
package leaves to tensorstore.  At first use ``load_library`` compiles every
source under ``csrc/`` with one ``g++`` call (``CXX_FLAGS``: the JAX
package's Makefile flags) into ``build/`` next to this file
(git-ignored).  The library's name carries a hash of the sources and
flags, so a changed source is rebuilt; the compiler writes to a temporary
name that is then renamed into place, so processes that build at once
each load a whole library.  Nothing is built at import time.  A missing
compiler or a failed build raises with the compiler's output: the port
never falls back to numpy on its own (``fastpath.accelerated``).

``CALLS`` counts, per C entry point, the calls made through ``call``: a
caller sets it to zero before a run and reads it after, to show that the
run went through the C++ code.  Worker processes count in their own copy.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")
LD_FLAGS = ("-shared", "-lpthread")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

# C entry point -> (argument types, result type)
ENTRY_POINTS = {
    "rle_decode_counts": ([ctypes.c_char_p, _I, _P, _I], _I),
    "rle_counts_to_mask": ([_P, _I, _I, _I, _P], None),
    "mask_bbox": ([_P, _I, _I, _P], _I),
    "crop_resize_normalize": ([_P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P], None),
    "crop_mask_nearest": ([_P, _I, _I, _I, _I, _I, _I, _I, _P], None),
    "render_templates_tex": ([_P, _P, _I, _P, _I, _P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _P, _P], None),
    "render_templates": ([_P, _P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _P, _P], None),
    "zstd_decompress": ([_P, _L, _P, _L, ctypes.c_char_p, _I], _L),
    "zstd_census": ([_P, _I], _I),
    "crc32c": ([_P, _L], ctypes.c_uint32),
}

CALLS: collections.Counter = collections.Counter()

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()
_count_lock = threading.Lock()


def compiler() -> str:
    """The C++ compiler: ``$CXX`` if set, else ``g++`` on the PATH."""
    cxx = os.environ.get("CXX", "g++")
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(f"C++ compiler {cxx!r} not found: the host library cannot be built")
    return found


def sources() -> list[str]:
    return sorted(os.path.join(CSRC_DIR, n) for n in os.listdir(CSRC_DIR) if n.endswith(".cpp"))


def library_path() -> str:
    h = hashlib.sha1(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    for path in sources():
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libpicopose_host-{h.hexdigest()[:12]}.so")


def build_library(out: str) -> str:
    """Compile every source into the library ``out`` (one g++ call, to a
    temporary name renamed into place); returns the compiler's output."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [compiler(), *CXX_FLAGS, *sources(), "-o", tmp, *LD_FLAGS]
    p = subprocess.run(cmd, capture_output=True, text=True)
    if p.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"host library build failed ({' '.join(cmd)}):\n{p.stdout}{p.stderr}")
    os.replace(tmp, out)
    return p.stdout + p.stderr


def load_library() -> ctypes.CDLL:
    """The host library, built at first use if it is not yet built."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                build_library(path)
            lib = ctypes.CDLL(path)
            for name, (argtypes, restype) in ENTRY_POINTS.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            _lib = lib
    return _lib


def available() -> bool:
    """Whether the host library loads (built now if it is not yet built),
    as the JAX package's ``native.available`` answers it.  No path of the
    port asks this to pick a route: a failed build raises where the
    library is used."""
    try:
        load_library()
    except (RuntimeError, OSError):
        return False
    return True


def call(name: str, *args):
    """Call C entry point ``name`` and count the call."""
    result = getattr(load_library(), name)(*args)
    with _count_lock:
        CALLS[name] += 1
    return result


def reset_calls() -> None:
    CALLS.clear()


def ptr(a) -> int | None:
    """The address of a contiguous numpy array's data, or None for None."""
    return None if a is None else a.ctypes.data
