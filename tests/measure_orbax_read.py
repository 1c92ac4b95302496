"""Time the port's orbax reader against the JAX package's on a ViT-L
PicoPose ``TrainState`` (configs/base.yaml's AdamW), on the host's CPU.

    JAX_PLATFORMS=cpu python tests/measure_orbax_read.py --dir /tmp/orbax_vitl --write [--rounds 2]

``--write`` saves the state through picopose_tpu/utils/checkpoint.py's
``manager`` and ``save`` under ``<dir>/checkpoints/1/``: the leaves' shapes
from ``jax.eval_shape`` of the model's init and of optax's (nothing is
computed), their values seeded draws (parameters and Adam's first moment
normal, the second moment its square), so the zstd frames hold what a
trained state's hold: fp32 noise, mostly Huffman-coded literals.  Then,
each in a fresh process and in turns for ``--rounds`` rounds:

* ``decoder``: the host library's zstd decoder, one thread, on the
  largest zarr chunk (one fp32 leaf) of the state;
* ``port load_any``: utils/checkpoint.py::load_any (params and
  batch_stats only);
* ``port read_step_dir``: the whole tree (utils/orbax_read.py);
* ``port restore``: utils/checkpoint.py::restore into a ViT-L fp32 port
  ``TrainState`` on the CPU (the state's construction not timed);
* ``jax load_any``: picopose_tpu/utils/checkpoint.py::load_any, the whole
  tree through orbax and tensorstore.

Prints one line per run (seconds, bytes decoded, GB/s) and the host CPU.
The page cache holds the files (they were just written): the reads are
warm.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VITL = dict(vit_type="dinov2_vitl14", blocks_to_take=(5, 11, 17, 23))


def write(out: str, seed: int = 0) -> None:
    import jax
    import jax.numpy as jnp

    from picopose_tpu.models import PicoPose
    from picopose_tpu.train import step as js
    from picopose_tpu.utils import checkpoint as ckpt

    model = PicoPose(**VITL, compute_dtype=jnp.float32)
    imgs = jnp.zeros((1, 224, 224, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), imgs, jnp.ones((1, 224, 224)), True))
    rng = np.random.default_rng(seed)
    draw = lambda s: jnp.asarray(rng.standard_normal(s.shape, np.float32) * 0.02)
    params = jax.tree.map(draw, shapes["params"])
    stats = jax.tree.map(lambda s: jnp.ones(s.shape, s.dtype), shapes["batch_stats"])
    tx = js.make_optimizer()
    opt = tx.init(params)
    adam = opt[0]._replace(count=jnp.asarray(7, jnp.int32), mu=jax.tree.map(draw, params))
    adam = adam._replace(nu=jax.tree.map(lambda m: m * m, adam.mu))
    opt = (adam, *opt[1:])
    state = js.TrainState(jnp.asarray(7, jnp.int32), params, stats, opt)
    mgr = ckpt.manager(out)
    t = time.perf_counter()
    ckpt.save(mgr, 1, state)
    mgr.wait_until_finished()
    print(f"saved in {time.perf_counter() - t!r} s")


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    return 0 if tree is None else int(np.asarray(tree).nbytes)


def run(what: str, out: str) -> None:
    """One timed read in this process."""
    step_dir = os.path.join(out, "checkpoints", "1")
    if what == "decoder":
        from picopose_tpu_torch.native.codec import zstd_decompress
        from picopose_tpu_torch.utils.ocdbt import OcdbtStore

        store = OcdbtStore(os.path.join(step_dir, "default"))
        size, key = max((len(store.read(k)), k) for k in store.list() if not k.endswith(".zarray"))
        frame, n = store.read(key), int(np.prod(json.loads(store.read(key.rsplit("/", 1)[0] + "/.zarray"))["chunks"])) * 4
        times = []
        for _ in range(3):
            t = time.perf_counter()
            zstd_decompress(frame, n)
            times.append(time.perf_counter() - t)
        print(f"decoder, one thread, the largest frame ({key}: {size} -> {n} bytes): best of 3 {min(times)!r} s, "
              f"{n / min(times) / 1e6!r} MB/s")
        return
    if what == "jax load_any":
        from picopose_tpu.utils.checkpoint import load_any

        t = time.perf_counter()
        tree = load_any(step_dir)
        n = _nbytes(tree)  # np.asarray of each leaf: on the CPU a view
        dt = time.perf_counter() - t
    elif what == "port restore":
        import torch

        from picopose_tpu_torch.train import step as ts
        from picopose_tpu_torch.utils import checkpoint as ckpt

        state = ts.init_state(ts.make_optimizer(), 0, device="cpu", **VITL, compute_dtype=torch.float32)
        t = time.perf_counter()
        ckpt.restore(out, None, state)
        dt = time.perf_counter() - t
        opt = state.optimizer
        n = sum(t.numel() * t.element_size() for t in (*state.model.state_dict().values(),
                                                      *(m for ms in opt.moments.values() for m in ms)))
    else:
        from picopose_tpu_torch.utils import checkpoint as ckpt
        from picopose_tpu_torch.utils.orbax_read import read_step_dir

        t = time.perf_counter()
        tree = ckpt.load_any(step_dir) if what == "port load_any" else read_step_dir(step_dir)
        dt = time.perf_counter() - t
        n = _nbytes(tree)
    print(f"{what}: {dt!r} s, {n} bytes, {n / dt / 1e9!r} GB/s")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", required=True)
    ap.add_argument("--write", action="store_true")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--run", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        run(args.run, args.dir)
        return
    if args.write:
        write(args.dir)
    on_disk = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(args.dir) for f in fs)
    lscpu = subprocess.run(["lscpu"], capture_output=True, text=True).stdout
    cpu = next((line.split(":", 1)[1].strip() for line in lscpu.splitlines() if line.startswith("Model name")), "?")
    print(f"{on_disk} bytes on disk; host CPU {cpu}, {os.cpu_count()} CPUs")
    env = dict(os.environ, PYTHONPATH=ROOT)
    for _ in range(args.rounds):
        for what in ("decoder", "port load_any", "port read_step_dir", "port restore", "jax load_any"):
            subprocess.run([sys.executable, os.path.abspath(__file__), "--dir", args.dir, "--run", what],
                           env=env, check=True)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
