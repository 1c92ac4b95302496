"""Hand-written CUDA kernels for Hopper (sm_90a), bound with ctypes.

Each source under ``csrc/`` exports a plain C function that launches its
kernel on the stream it is given and returns ``cudaGetLastError()``.  At
first use the loader compiles every source that is not yet built, one
``nvcc -shared`` per source, all started together, into ``build/`` next to
this file (git-ignored; the library name carries a hash of the sources and
flags, so a changed source is rebuilt).  Nothing is built at import time.

``LAUNCHES`` counts, per kernel, the launches made through ``launch``: a
caller sets it to zero before a run and reads it after, to show that the
run went through the kernels.  A launch made while its stream captures a
CUDA graph is not counted: it runs only when the graph is replayed, and
no wrapper runs then (utils/graphs.py).  A kernel may have several names that share
one source and entry point (K3's int8 branch, ``match_scores_int8``), so
that each branch is counted on its own; the source is built once.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_S = ctypes.c_char_p  # int64 values packed with struct.pack

_MATCH = ("matching.cu", "pp_match_scores", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P])

# kernel name -> (source file, C entry point, argument types)
KERNELS = {
    "layernorm": ("layernorm.cu", "pp_layernorm", [_P, _P, _P, _P, _L, _I, _F, _I, _P]),
    "attention": ("attention.cu", "pp_attention", [_P, _P, _P, _P, _I, _I, _I, _I, _S, _F, _I, _P]),
    "match_scores": _MATCH,  # bf16 and fp32 operands
    "match_scores_int8": _MATCH,  # the int8 operands of the serving mode
    "corr_window": ("corr.cu", "pp_corr_window", [_P, _P, _P, _S, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P, _P]),
    "warp": ("warp.cu", "pp_warp", [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
}

LAUNCHES: collections.Counter = collections.Counter()

_libs: dict[str, ctypes.CDLL] = {}
_entries: dict[str, object] = {}  # kernel name -> its C entry point
_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found is None and CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        found = cand if os.path.exists(cand) else None
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _library_path(source: str) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC_DIR)):
        if name == source or name.endswith(".cuh"):
            with open(os.path.join(CSRC_DIR, name), "rb") as f:
                h.update(name.encode() + f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:12]}.so")


def _load(name: str, path: str) -> None:
    _, entry, argtypes = KERNELS[name]
    lib = ctypes.CDLL(path)
    fn = getattr(lib, entry)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.pp_error_string.argtypes, lib.pp_error_string.restype = [_I], ctypes.c_char_p
    _libs[name] = lib
    _entries[name] = fn


def build(names=None, verbose: bool = False) -> dict[str, str]:
    """Compile and load the named kernels (all by default) that are not yet
    loaded; one nvcc process per source, run in parallel.  Returns the
    compiler's output per source file (with ``verbose``, ptxas's register
    and shared-memory report)."""
    names = list(KERNELS) if names is None else list(names)
    logs: dict[str, str] = {}
    with _lock:
        todo = [n for n in names if n not in _libs]
        if not todo:
            return logs
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = {}  # source -> (nvcc process or None, temporary path, library path)
        for src in dict.fromkeys(KERNELS[n][0] for n in todo):
            out = _library_path(src)
            if os.path.exists(out) and not verbose:
                procs[src] = (None, out, out)
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                   "-o", tmp, os.path.join(CSRC_DIR, src)]
            p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            procs[src] = (p, tmp, out)
        failed, built = [], set()
        for src, (p, tmp, out) in procs.items():
            if p is not None:
                text = p.communicate()[0].decode(errors="replace")
                logs[src] = text
                if p.returncode != 0:
                    failed.append(f"{src}:\n{text}")
                    continue
                os.replace(tmp, out)
            built.add(src)
        for n in todo:
            if KERNELS[n][0] in built:
                _load(n, procs[KERNELS[n][0]][2])
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def launch(name: str, *args) -> None:
    """Launch kernel ``name`` (building it at first use) and count the
    launch, unless the current stream is capturing a CUDA graph.

    Raises if the launch was refused; a fault during the run shows at the
    next synchronisation."""
    import torch

    fn = _entries.get(name)
    if fn is None:
        build([name])
        fn = _entries[name]
    err = fn(*args)
    if err != 0:
        msg = _libs[name].pp_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err} ({msg})")
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES[name] += 1


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built at first use), for the
    helpers its source exports beside its entry point."""
    if name not in _libs:
        build([name])
    return _libs[name]


def reset_launches() -> None:
    LAUNCHES.clear()


def contiguous_aligned(t, align: int = 32):
    """``t`` contiguous and starting on an ``align``-byte boundary, as the
    kernels' 16-byte vector and tensor-core fragment loads need."""
    import torch

    t = t.contiguous()
    return t if t.data_ptr() % align == 0 else t.clone(memory_format=torch.contiguous_format)


def stream_of(t) -> int:
    """Raw handle of the current CUDA stream on ``t``'s device."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.get_device())


def on_device_of(t):
    """A context that makes ``t``'s card the current device, as the C entry
    points launch there; a no-op when it already is."""
    import torch

    index = t.get_device()
    if index == torch._C._cuda_getDevice():
        return contextlib.nullcontext()
    return torch.cuda.device(index)
