"""A rank of the port's sharded training step, for tests/test_torch_distributed.py.

Run in ``spawn``ed processes: it imports the port, torch and numpy only.
Each rank joins a gloo group of 2 or 4 ranks on the CPU, loads the
weights, the global batch and the affine noise the test wrote to
``work``, and for each run of its world (``WORLDS``: ddp, fsdp and tp over
2 ranks, fsdp_tp over 2 x 2) runs the sharded step (``grad_accum`` 2: step
1 accumulates, step 2 updates, step 3 accumulates) on its rows of the
global batch.  Rank 0 writes, per mode, the gathered gradients after step
1, the gathered state after the update and the BatchNorm statistics after
each step (``<mode>.pt``), and the world's first run saves a checkpoint
after step 3; every rank writes its loss dicts, rows, digests of its
replicated tensors and the bytes it holds (``world<n>_rank<r>.pkl``).
Then the checkpoint is restored into other layouts, and the host
broadcast and the barrier are exercised.
"""

from __future__ import annotations

import hashlib
import os
import pickle

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


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().numpy().tobytes()).hexdigest()


def fresh_state(work: str, device: str = "cpu"):
    from picopose_tpu_torch.train import step as ts

    state = ts.init_state(ts.make_optimizer(**OPT, grad_accum=2), 0, device=device, **SMALL,
                          compute_dtype=torch.float32)
    weights = torch.load(os.path.join(work, "weights.pt"), weights_only=True)
    state.model.load_state_dict(weights)
    return state


def inputs(work: str):
    from picopose_tpu_torch.train.augment import AffineNoise

    with np.load(os.path.join(work, "batch.npz")) as z:
        batch = {k: z[k] for k in z.files}
    with open(os.path.join(work, "noise.pkl"), "rb") as f:
        noises = [AffineNoise(*(torch.from_numpy(a) for a in n)) for n in pickle.load(f)]
    return batch, noises


def main(rank: int, world: int, port: int, work: str) -> None:
    torch.set_num_threads(1)
    from picopose_tpu_torch.parallel import distributed as pd
    from picopose_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from picopose_tpu_torch.parallel.shardings import (
        full_optimizer_state, full_state_dict, shard_state, state_shardings,
    )
    from picopose_tpu_torch.train import step as ts
    from picopose_tpu_torch.utils import checkpoint as ckpt

    pd.initialize(backend="gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
    try:
        batch, noises = inputs(work)
        out: dict = {"rank": rank}
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
        out["broadcast"] = pd.broadcast_host_data({"from": rank, "world": pd.process_info()[1]})
        pd.all_hosts_barrier("end")
        with open(os.path.join(work, f"world{world}_rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        pd.shutdown()
