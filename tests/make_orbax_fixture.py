"""Write ``tests/data/orbax_small/`` and ``tests/data/orbax_sharded/``:
checkpoints of the JAX package, saved by its own orbax code, that the port
reads without JAX (utils/orbax_read.py) in tests/test_torch_orbax.py,
tests/torch_dist_worker.py and ``chip_smoke.py`` phase 17, on a machine
that has no JAX and no orbax.

    JAX_PLATFORMS=cpu python tests/make_orbax_fixture.py [--out DIR] [--seed 0]
    JAX_PLATFORMS=cpu python tests/make_orbax_fixture.py --processes 2 [--out DIR] [--seed 0]

At the parity tests' small config (``vit_tiny_test``, taps 0-3, fp32;
tests/torch_parity.py::SMALL), through picopose_tpu/utils/checkpoint.py's
``manager`` and ``save``:

* ``variables/checkpoints/3/``: ``{'params', 'batch_stats'}``;
* ``train/checkpoints/5/``: the ``TrainState`` of configs/base.yaml's AdamW
  under ``optax.MultiSteps`` (grad_accum 2) five steps in, in the middle
  of an accumulation: step 5, ``mini_step`` 1, ``gradient_step`` and the
  Adam and schedule counts 2, the same params and batch_stats;
* ``leaves.npz``: every leaf of the ``TrainState`` (the variables'
  leaves are among them), as ``tile/<path>`` and ``shape/<path>``, the
  leaf being the tile repeated to the shape (``np.resize``), ``<path>``
  its keys joined by "/".

With ``--processes 2`` the script writes ``orbax_sharded/`` instead: the
same ``TrainState`` (every leaf bitwise ``orbax_small``'s) as a pod saves
it, in ``train/checkpoints/5/`` only.  It starts two processes of itself,
each with two CPU devices (``--xla_force_host_platform_device_count=2``),
joined by the JAX package's ``parallel/distributed.py::initialize`` over
gloo CPU collectives; they build ``make_mesh(n_data=2, n_model=2)``, lay
the state out with ``shard_state(state, mesh, "fsdp_tp")`` and save it
with ``utils/checkpoint.py``'s ``manager`` and ``save``.  Each process
writes the shards it holds into its own ``ocdbt.process_<i>/`` store, one
zarr chunk per shard, so the split leaves are stored as several chunks
over both mesh axes (~20 s).

The small model has 71 M parameters (the heads' widths do not shrink with
the ViT's), so the leaves are not independent draws, which would take
some 1.1 GB: each is a seeded tile of ``TILE`` values (scaled as an
initialiser would scale it: kernels by 1/sqrt(fan-in), norm scales and
variances about 1) repeated to the leaf's shape, which zstd stores in a
few hundred bytes.  The whole directory is about 2 MB.
"""

from __future__ import annotations

import argparse
import os
import shutil
import socket
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "orbax_small")
OUT_SHARDED = os.path.join(ROOT, "tests", "data", "orbax_sharded")
MESH = (2, 2)  # (n_data, n_model) of the sharded save
PROCESSES = 2  # its processes, of MESH[0] * MESH[1] // PROCESSES CPU devices each
TILE = 61  # values per tile: a prime, so a tile's repeats do not line up with a leaf's rows
VARIABLES_STEP, TRAIN_STEP = 3, 5
GRAD_ACCUM, MINI_STEP, UPDATES = 2, 1, 2


def _leaf(rng, path: tuple[str, ...], shape: tuple[int, ...], dtype) -> np.ndarray:
    """A tile for the leaf at ``path``."""
    t = rng.standard_normal(TILE).astype(np.float64)
    name, top = path[-1], path[0]
    if top == "opt_state":
        moment = next((p for p in path if p in ("mu", "nu", "acc_grads")), None)
        scale = {"mu": 1e-2, "acc_grads": 1e-2}.get(moment)
        t = 1e-4 * (t * t + 0.1) if moment == "nu" else t * scale if scale else t
    elif name in ("scale", "var"):
        t = 1.0 + 0.1 * np.abs(t)
    elif name == "kernel":
        t = t / np.sqrt(max(1, int(np.prod(shape[:-1]))))
    else:  # biases, means, tokens, embeddings, LayerScale
        t = 0.02 * t
    return t.astype(dtype)


def tiles(seed: int = 0) -> dict[str, tuple[np.ndarray, tuple[int, ...]]]:
    """``{path: (tile, shape)}`` for every array leaf of the TrainState,
    from the shapes of the JAX model's init (``jax.eval_shape``: nothing
    is computed) and of optax's state."""
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_parity import SMALL

    from picopose_tpu.models import PicoPose
    from picopose_tpu.train import step as js

    model = PicoPose(**SMALL, compute_dtype=jnp.float32)
    imgs = jnp.zeros((1, 224, 224, 3), jnp.float32)
    variables = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), imgs, jnp.ones((1, 224, 224)), True))
    tx = js.make_optimizer(grad_accum=GRAD_ACCUM)
    state = js.TrainState(jax.ShapeDtypeStruct((), jnp.int32), variables["params"], variables["batch_stats"],
                          jax.eval_shape(tx.init, variables["params"]))
    out = {}
    leaves = jax.tree_util.tree_leaves_with_path(state._asdict())
    for i, (kp, leaf) in enumerate(leaves):
        path = tuple(str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k)))) for k in kp)
        shape = tuple(leaf.shape)
        rng = np.random.default_rng([seed, i])
        if not shape:  # step, counts, mini_step
            value = {"step": TRAIN_STEP, "mini_step": MINI_STEP}.get(path[-1], UPDATES)
            out["/".join(path)] = (np.asarray([value], np.dtype(leaf.dtype)), shape)
        else:
            out["/".join(path)] = (_leaf(rng, path, shape, np.dtype(leaf.dtype)), shape)
    return out


def expand(tile: np.ndarray, shape) -> np.ndarray:
    return np.resize(tile, tuple(shape))


def leaves(seed: int = 0) -> dict[str, np.ndarray]:
    """``{path: array}``: what the fixture's TrainState holds."""
    return {p: expand(t, s) for p, (t, s) in tiles(seed).items()}


def train_state(seed: int = 0):
    """The JAX package's ``TrainState`` that ``leaves(seed)`` describes."""
    import jax
    import jax.numpy as jnp

    from picopose_tpu.train import step as js

    tree: dict = {}
    for path, value in leaves(seed).items():
        node = tree
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = jnp.asarray(value)
    tx = js.make_optimizer(grad_accum=GRAD_ACCUM)
    template = tx.init(tree["params"])
    opt_leaves = jax.tree_util.tree_leaves_with_path(template)
    values = []
    for kp, _ in opt_leaves:
        node = tree["opt_state"]
        for k in kp:
            node = node[str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k))))]
        values.append(node)
    opt_state = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(template), values)
    return js.TrainState(tree["step"], tree["params"], tree["batch_stats"], opt_state)


def _save(log_dir: str, step: int, item) -> None:
    from picopose_tpu.utils import checkpoint as ckpt

    mgr = ckpt.manager(log_dir)
    ckpt.save(mgr, step, item)
    mgr.wait_until_finished()


def write(out: str = OUT, seed: int = 0) -> None:
    state = train_state(seed)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    for name, step, item in (("variables", VARIABLES_STEP, {"params": state.params, "batch_stats": state.batch_stats}),
                             ("train", TRAIN_STEP, state)):
        _save(os.path.join(out, name), step, item)
    arrays = {}
    for path, (tile, shape) in tiles(seed).items():
        arrays[f"tile/{path}"] = tile
        arrays[f"shape/{path}"] = np.asarray(shape, np.int64)
    np.savez_compressed(os.path.join(out, "leaves.npz"), **arrays)


def write_sharded(out: str = OUT_SHARDED, seed: int = 0) -> None:
    """Start ``PROCESSES`` processes of this script (``_sharded_process``)
    and wait for them."""
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={MESH[0] * MESH[1] // PROCESSES}"}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--out", out, "--seed", str(seed),
                               "--processes", str(PROCESSES), "--process_id", str(i), "--port", str(port)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(PROCESSES)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for i, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"process {i} of the sharded save failed (exit code {p.returncode}):\n{log[-3000:]}")


def _sharded_process(out: str, seed: int, process_id: int, port: int) -> None:
    """One process of the sharded save."""
    import jax

    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    from picopose_tpu.parallel import distributed
    from picopose_tpu.parallel.mesh import make_mesh
    from picopose_tpu.parallel.shardings import shard_state

    distributed.initialize(coordinator_address=f"localhost:{port}", num_processes=PROCESSES, process_id=process_id)
    mesh = make_mesh(n_data=MESH[0], n_model=MESH[1])
    state = shard_state(train_state(seed), mesh, "fsdp_tp")
    _save(os.path.join(out, "train"), TRAIN_STEP, state)
    distributed.all_hosts_barrier("saved")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="default: tests/data/orbax_small, with --processes 2 orbax_sharded")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--processes", type=int, choices=(1, PROCESSES), default=1,
                    help=f"{PROCESSES}: the sharded save of orbax_sharded/")
    ap.add_argument("--process_id", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    out = args.out or (OUT if args.processes == 1 else OUT_SHARDED)
    if args.process_id is not None:
        _sharded_process(out, args.seed, args.process_id, args.port)
        return
    (write if args.processes == 1 else write_sharded)(out, args.seed)
    total = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(out) for f in fs)
    print(f"wrote {out}: {total} bytes")


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
