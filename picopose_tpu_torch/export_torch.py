"""Export a checkpoint as a reference-loadable torch .ckpt (host only).

    python -m picopose_tpu_torch.export_torch <checkpoint> <out.ckpt> [--depth 24] [--raw]

The port's counterpart of tools/export_torch.py, with the same arguments.
<checkpoint> is a train state the port saved
(``log/<model>/version_<id>/checkpoints/<step>.pt``, utils/checkpoint.py::
save), a reference torch ``.ckpt`` / ``.pth``, or the JAX package's orbax
step directory (``.../checkpoints/<step>/``, read without JAX by
utils/orbax_read.py).  Each is read by
utils/checkpoint.py::load_any and goes through the porter
(utils/torch_port.py) into flax-layout variables, then back to the
reference ``Net``'s keys, as the JAX tool round-trips a torch file: the
modules that never run in the reference (DPT refinenet1 and output convs,
the ViT's mask token and final norm) are not written, every BatchNorm's
``num_batches_tracked`` is written as 0 (a 0-d tensor, as torch's
BatchNorm holds it; the JAX tool's file holds a (1,) one, which torch
also loads), and refinenet4's unused first residual unit is written back
where the input carried it.  ``--depth`` is
the ViT's block count (24 for ViT-L, 12 for ViT-S); ``--raw`` writes a
bare ``Net`` state dict instead of the Lightning ``{'state_dict':
{'network.*'}}`` wrapper.  Load into the reference with ``strict=False``.
A directory that is not an orbax checkpoint raises with its path.  Runs
on the host; it needs no card.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Export a checkpoint as a reference-loadable torch .ckpt")
    ap.add_argument("checkpoint", help="a port train state (.pt), a torch .ckpt / .pth or an orbax step dir")
    ap.add_argument("out", help="output .ckpt path")
    ap.add_argument("--depth", type=int, default=24, help="ViT depth (24 for ViT-L)")
    ap.add_argument("--raw", action="store_true", help="bare state dict, no Lightning wrapper")
    return ap


def reference_state_dict(checkpoint: str, depth: int = 24) -> dict[str, np.ndarray]:
    """The reference ``Net`` state dict a checkpoint exports to."""
    from picopose_tpu_torch.utils.checkpoint import load_any
    from picopose_tpu_torch.utils.torch_export import export_state_dict
    from picopose_tpu_torch.utils.weights import state_dict_from_flax

    variables = load_any(checkpoint, depth=depth)
    state = state_dict_from_flax(variables, dead_units=True)
    return export_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state.items()})


def main(argv: list[str] | None = None) -> str:
    args = get_parser().parse_args(argv)
    from picopose_tpu_torch.utils.torch_export import write_checkpoint

    write_checkpoint(reference_state_dict(args.checkpoint, args.depth), args.out, lightning=not args.raw)
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
