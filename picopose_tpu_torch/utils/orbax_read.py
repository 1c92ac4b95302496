"""The JAX package's orbax checkpoints, read without JAX, orbax or
tensorstore: ``read_step_dir(path)`` -> the saved tree as nested dicts and
lists of numpy arrays, as the JAX package's
``utils/checkpoint.py::load_any`` restores it.

A checkpoint of the JAX package is a ``CheckpointManager`` step directory
``<log_dir>/checkpoints/<step>/`` whose payload sits in ``default/``; the
item directory itself is read too.  The item directory holds
``_METADATA`` (JSON: ``tree_metadata``, each leaf's key path with key
types, 1 a sequence index and 2 a dict key or a named tuple's field, and
its value type) and an OCDBT store (utils/ocdbt.py) with one zarr v2 array
per leaf (utils/zarr2.py), named by its key path joined with ".".  Leaves
whose value type is "None" or an empty container come back as None, (),
{} or []; the rest are arrays (bf16 under ``weights.BF16_TAG``).

Only the format orbax writes by default is read: OCDBT (``use_ocdbt``)
with zarr v2 arrays (not ``use_zarr3``).
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Collection

from picopose_tpu_torch.utils.ocdbt import OcdbtStore
from picopose_tpu_torch.utils.zarr2 import Region, read_array

METADATA = "_METADATA"
_EMPTY = {"None": lambda: None, "Tuple": tuple, "Dict": dict, "List": list}
_SEQUENCE, _DICT = 1, 2


def item_dir(path: str) -> str:
    """The item directory of an orbax checkpoint at ``path``: ``path``
    itself when it holds ``_METADATA``, else its ``default/`` (a
    ``CheckpointManager`` step directory), as the JAX ``load_any`` picks
    it.  Raises ValueError naming ``path`` when neither is one."""
    if os.path.isfile(os.path.join(path, METADATA)):
        return path
    default = os.path.join(path, "default")
    if os.path.isfile(os.path.join(default, METADATA)):
        return default
    raise ValueError(
        f"{path}: not an orbax checkpoint (neither {METADATA} nor default/{METADATA} is there): "
        "a directory is read as the JAX package's orbax step directory or item directory"
    )


def _containers(node, kind: int | None):
    """A node of ``read_step_dir``'s tree (key -> (child, the type of the
    child's keys), None at a leaf) -> dicts and lists by key type."""
    if not isinstance(node, dict) or kind is None:
        return node
    out = {k: _containers(v, t) for k, (v, t) in node.items()}
    if kind == _SEQUENCE:
        if sorted(out) != list(range(len(out))):
            raise ValueError(f"sequence indices {sorted(out)} are not 0..{len(out) - 1}")
        return [out[i] for i in range(len(out))]
    return out


def read_step_dir(path: str, top: Collection[str] | None = None,
                  region: Callable[[tuple], Region | None] | None = None) -> dict:
    """The tree saved at ``path`` (an orbax step or item directory), or
    with ``top`` only the subtrees under those top-level keys (a train
    state's ``params`` and ``batch_stats`` without its optimizer state),
    its arrays read by a thread per core (at most 32), which decode chunks
    in parallel.  ``region``: a leaf's key path (a tuple of dict keys and
    sequence indices) -> the part of it to read (utils/zarr2.py), None
    for all of it."""
    item = item_dir(path)
    with open(os.path.join(item, METADATA)) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False):
        raise ValueError(f"{item}: an orbax checkpoint without OCDBT is not read (use_ocdbt is false)")
    if meta.get("use_zarr3", False):
        raise ValueError(f"{item}: an orbax checkpoint of zarr v3 arrays is not read (use_zarr3 is true)")
    store = OcdbtStore(item)
    leaves = []
    for entry in meta["tree_metadata"].values():
        keys = [(int(k["key"]) if k["key_type"] == _SEQUENCE else k["key"], k["key_type"])
                for k in entry["key_metadata"]]
        if any(t not in (_SEQUENCE, _DICT) for _, t in keys):
            raise ValueError(f"{item}: key types {[t for _, t in keys]}, only 1 (sequence) and 2 (dict) are read")
        if top is None or keys[0][0] in top:
            leaves.append((keys, entry["value_metadata"].get("value_type")))
    arrays = [tuple(k for k, _ in keys) for keys, vt in leaves if vt not in _EMPTY]
    names = [".".join(str(k) for k in path) for path in arrays]
    parts = [region(path) if region else None for path in arrays]
    with ThreadPoolExecutor(min(32, os.cpu_count() or 1)) as pool:
        values = dict(zip(names, pool.map(lambda a: read_array(store, *a), zip(names, parts))))
    # the tree, each node keyed (key -> (child, type of the child's keys))
    tree: dict = {}
    for keys, vt in leaves:
        node = tree
        for depth, (key, _) in enumerate(keys):
            child_kind = keys[depth + 1][1] if depth + 1 < len(keys) else None
            if depth + 1 == len(keys):
                value = _EMPTY[vt]() if vt in _EMPTY else values[".".join(str(k) for k, _ in keys)]
                node[key] = (value, None)
            else:
                node = node.setdefault(key, ({}, child_kind))[0]
    root_kind = leaves[0][0][0][1] if leaves else _DICT
    return _containers(tree, root_kind)
