"""A rank of the port's sharded training step, for tests/test_torch_distributed.py.

Run in ``spawn``ed processes: it imports the port, torch and numpy only.
Each rank joins a gloo group of 2 or 4 ranks on the CPU (``GROUPS``) and
loads the weights, the global batch and the affine noise the test wrote
to ``work``.

A "train" rank, for each run of its world (``WORLDS``: ddp, fsdp and tp
over 2 ranks, fsdp_tp over 2 x 2), runs the sharded step (``grad_accum``
2: step 1 accumulates, step 2 updates, step 3 accumulates) on its rows of
the global batch.  Rank 0 writes, per mode, the gathered gradients after
step 1, the gathered state after the update and the BatchNorm statistics
after each step (``<mode>.pt``), and the world's first run saves a
checkpoint after step 3; every rank records its loss dicts, rows,
digests of its replicated tensors and the bytes it holds.  Then the
checkpoint is restored into other layouts.

The JAX package's training run resumes over the ranks (an "orbax" rank,
or a "train" rank of a world not in ``ORBAX_APART`` after its runs): in
each layout of ``ORBAX_LAYOUTS`` the rank restores, in place into one
state, the one-process restore of ``orbax_small`` that the test saved as
``orbax_pt/checkpoints/5.pt`` (the reference) and the committed orbax
fixtures (``ORBAX``: one process's save, and two processes' save over a
2 x 2 fsdp_tp mesh), and takes one step from the ``.pt``'s restore and
from the two processes' (``STEPPED``; the one that completes the
fixture's open accumulation and updates) on a row per data rank (the
global batch repeated where there are more data ranks than its rows).
It records digests of its tensors after each restore and after each
step, the losses, and the bytes of zarr chunks it decoded.

Every rank exercises the host broadcast and the barrier, and writes what
it recorded to ``<task><world>_rank<rank>.pkl``.
"""

from __future__ import annotations

import os
import pickle
import zlib

import numpy as np
import torch

SMALL = dict(vit_type="vit_tiny_test", blocks_to_take=(0, 1, 2, 3))
OPT = dict(base_lr=1e-3, max_iters=10_000, warmup_factor=1.0)
STEPS = 3
# per world size: the runs (mode, n_data, n_model), the first one's
# checkpoint, and the layouts it is restored into
WORLDS = {
    2: dict(runs=[("ddp", 2, 1), ("fsdp", 2, 1), ("tp", 1, 2)], restore=[("tp", 1, 2)]),
    4: dict(runs=[("fsdp_tp", 2, 2)], restore=[("ddp", 4, 1)]),
}
MODES = [run[0] for w in WORLDS.values() for run in w["runs"]]
ORBAX_LAYOUTS = {2: [("ddp", 2, 1), ("fsdp", 2, 1), ("tp", 1, 2)], 4: [("fsdp_tp", 2, 2), ("ddp", 4, 1)]}
# worlds whose resumes run in a group of ranks of their own, beside the training runs (whose ranks are busiest)
ORBAX_APART = (2,)
GROUPS = [(world, "train") for world in WORLDS] + [(world, "orbax") for world in ORBAX_APART]
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
ORBAX = {"orbax_small": os.path.join(DATA, "orbax_small", "train"),
         "orbax_sharded": os.path.join(DATA, "orbax_sharded", "train")}
PT = "orbax_pt"  # under ``work``: the one-process restore of orbax_small, saved by the port
# the sources stepped after their restore: orbax_small's restore is held bitwise to the .pt's
# and not stepped too, since a step reads nothing that the digests do not cover
STEPPED = (PT, "orbax_sharded")


def _digest(t: torch.Tensor) -> str:
    return f"{zlib.crc32(t.detach().contiguous().numpy()):08x}"


def fresh_state(work: str, device: str = "cpu"):
    from picopose_tpu_torch.train import step as ts

    state = ts.init_state(ts.make_optimizer(**OPT, grad_accum=2), 0, device=device, **SMALL,
                          compute_dtype=torch.float32)
    weights = torch.load(os.path.join(work, "weights.pt"), weights_only=True)
    state.model.load_state_dict(weights)
    return state


def state_digests(state) -> dict[str, str]:
    """Digests of everything a step reads of a rank's state: its
    parameters' shards, buffers, moments and gradients, and counters."""
    layout, opt = state.layout, state.optimizer
    out = {f"model.{n}": _digest(t) for n, t in zip(layout.names, layout.local)}
    out.update({f"model.{n}": _digest(b) for n, b in state.model.named_buffers()})
    for k, moment in opt.moments.items():
        out.update({f"{k}.{n}": _digest(t) for n, t in zip(layout.names, moment)})
    out.update({f"grad.{n}": _digest(g) for n, g in zip(layout.names, opt.grads)})
    out["counters"] = repr((state.step, int(opt.count), opt.updates, opt.mini_step))
    return out


def orbax_resumes(world: int, work: str, batch, noise) -> dict:
    """{(mode, source): {before, after, losses, decoded}} over
    ``ORBAX_LAYOUTS[world]`` and the sources ``PT`` and ``ORBAX``."""
    from picopose_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from picopose_tpu_torch.parallel.shardings import shard_state, state_shardings
    from picopose_tpu_torch.train import step as ts
    from picopose_tpu_torch.utils import checkpoint as ckpt
    from picopose_tpu_torch.utils import zarr2

    out = {}
    for mode, n_data, n_model in ORBAX_LAYOUTS[world]:
        mesh = make_mesh(n_data, n_model, "cpu")
        reps = max(1, n_data // len(noise.scale))  # a row per data rank: the global batch repeated
        rows = shard_batch({k: np.concatenate([v] * reps) for k, v in batch.items()}, mesh)
        noise_n = noise._replace(**{k: torch.cat([getattr(noise, k)] * reps) for k in ("scale", "rot", "trans")})
        state = shard_state(fresh_state(work), mesh, mode)
        step = ts.make_train_step(state, state_shardings(mesh, state, mode), mesh)
        for source, log_dir in ((PT, os.path.join(work, PT)), *ORBAX.items()):
            zarr2.CHUNK_BYTES.clear()
            ckpt.restore(log_dir, None, state)  # in place: all that a step reads or writes
            res = out[mode, source] = dict(before=state_digests(state), decoded=sum(zarr2.CHUNK_BYTES.values()))
            if source in STEPPED:
                res["losses"] = {k: float(v) for k, v in step(state, rows, noise_n).items()}
                res["after"] = state_digests(state)
        del state, step
    return out


def inputs(work: str):
    from picopose_tpu_torch.train.augment import AffineNoise

    with np.load(os.path.join(work, "batch.npz")) as z:
        batch = {k: z[k] for k in z.files}
    with open(os.path.join(work, "noise.pkl"), "rb") as f:
        noises = [AffineNoise(*(torch.from_numpy(a) for a in n)) for n in pickle.load(f)]
    return batch, noises


def training_runs(rank: int, world: int, work: str, batch, noises) -> dict:
    """The world's runs (``WORLDS``) and their checkpoint's restores."""
    from picopose_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from picopose_tpu_torch.parallel.shardings import (
        full_optimizer_state, full_state_dict, shard_state, state_shardings,
    )
    from picopose_tpu_torch.train import step as ts
    from picopose_tpu_torch.utils import checkpoint as ckpt

    out: dict = {}
    plan = WORLDS[world]
    saved = os.path.join(work, f"ckpt{world}")
    for i, (mode, n_data, n_model) in enumerate(plan["runs"]):
        mesh = make_mesh(n_data, n_model, "cpu")
        rows = shard_batch(batch, mesh)
        state = shard_state(fresh_state(work), mesh, mode)
        step = ts.make_train_step(state, state_shardings(mesh, state, mode), mesh)
        layout = state.layout
        res: dict = {"losses": [], "held": layout.held_bytes(state.optimizer), "rows": rows["real_pose"],
                     "coords": (mesh.data_index, mesh.model_index)}
        res["split"] = {n: (tuple(t.shape), tuple(s), (n_data if p.data is not None else 1)
                            * (n_model if p.model is not None else 1))
                        for n, s, p, t in zip(layout.names, layout.shapes, layout.specs, layout.local) if p.split}
        tensors: dict = {"stats": []}
        for k in range(STEPS):
            losses = step(state, rows, noises[k])
            res["losses"].append({name: float(v) for name, v in losses.items()})
            if k == 0:
                tensors["grads"] = dict(zip(layout.names, full_optimizer_state(state)["grads"]))
            sd = {name: v.clone() for name, v in full_state_dict(state).items()}
            tensors["stats"].append({name: v for name, v in sd.items() if "running" in name})
            if k == 1:
                tensors["updated"] = sd
        if rank == 0:
            torch.save(tensors, os.path.join(work, f"{mode}.pt"))
        del tensors
        res["replicated"] = {
            **{n: _digest(t) for n, s, t in zip(layout.names, layout.specs, layout.local) if not s.split},
            **{n: _digest(b) for n, b in state.model.named_buffers()},
        }
        if i == 0:
            res["ckpt"] = ckpt.save(saved, state.step, state, 0)
        out[mode] = res
        del state, step
    # the first run's file restored into other layouts, whole and bitwise
    payload = torch.load(out[plan["runs"][0][0]]["ckpt"], weights_only=True)
    out["restored"] = {}
    for mode, n_data, n_model in plan["restore"]:
        state = shard_state(fresh_state(work), make_mesh(n_data, n_model, "cpu"), mode)
        ckpt.restore(saved, None, state)
        sd, opt = full_state_dict(state), full_optimizer_state(state)
        out["restored"][mode] = dict(
            model=all(torch.equal(sd[k], payload["model"][k]) for k in payload["model"]),
            moments=all(torch.equal(opt["optimizer"]["state"][i][k], v)
                        for i, m in payload["optimizer"]["state"].items() for k, v in m.items()),
            grads=all(torch.equal(a, b) for a, b in zip(opt["grads"], payload["grads"])),
            counters=(state.step, opt["scheduler"], opt["mini_step"])
            == (payload["step"], payload["scheduler"], payload["mini_step"]),
        )
        del state
    del payload
    return out


def main(rank: int, world: int, port: int, work: str, task: str = "train") -> None:
    """One rank of a group of ``world``: its ``task`` is "train" (the
    world's training runs, then the JAX run's resumes unless they run
    apart: ``ORBAX_APART``) or "orbax" (those resumes alone); the results
    go to ``<task><world>_rank<rank>.pkl``."""
    torch.set_num_threads(1)
    from picopose_tpu_torch.parallel import distributed as pd

    pd.initialize(backend="gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
    try:
        batch, noises = inputs(work)
        out: dict = {"rank": rank}
        if task == "train":
            out.update(training_runs(rank, world, work, batch, noises))
        if task == "orbax" or world not in ORBAX_APART:
            out["orbax"] = orbax_resumes(world, work, batch, noises[0])
        out["broadcast"] = pd.broadcast_host_data({"from": rank, "world": pd.process_info()[1]})
        pd.all_hosts_barrier("end")
        with open(os.path.join(work, f"{task}{world}_rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        pd.shutdown()
