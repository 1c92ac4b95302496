"""BOP evaluation entry point of the PyTorch port.

    python -m picopose_tpu_torch.run_test --dataset lmo --config configs/base.yaml \
        --checkpoint_path model.ckpt [--view 42] [--hyp 5] [--device cuda] \
        [--set key=value ...]

Counterpart of run_test.py (:18-131) with the same flags plus ``--device``
(the card unless ``cpu`` is passed).  Writes the bop19 CSV
``picopose-stage3-<hyp>hyp_<dataset>-test.csv`` under
``log/<model>/version_<id>/<dataset>_eval/``, relative to the working
directory.  ``--checkpoint_path`` takes a reference PyTorch checkpoint
(``.ckpt``/``.pth``) or a train state the port saved; ``none`` resolves ``--iter``
(or the latest step) to ``log/<model>/version_<id>/checkpoints/<step>.pt``
as the JAX entry point resolves its step directories, and with no checkpoint found the weights are drawn from seed 0
(a smoke run, with a warning).
"""

from __future__ import annotations

import argparse
import os

import torch

from picopose_tpu_torch.data.bop import BOP7, DETECTION_FILES, BOPTestDataset
from picopose_tpu_torch.device import resolve_device
from picopose_tpu_torch.eval.runner import evaluate_dataset
from picopose_tpu_torch.models import PicoPose
from picopose_tpu_torch.models.dinov2 import VIT_CONFIGS
from picopose_tpu_torch.utils.checkpoint import checkpoint_dir, checkpoint_path, load_any
from picopose_tpu_torch.utils.config import load_config
from picopose_tpu_torch.utils.weights import init_random_, load_flax_variables

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="PicoPose evaluation (PyTorch port)")
    p.add_argument("--model", default="picopose")
    p.add_argument("--config", default="configs/base.yaml")
    p.add_argument("--dataset", default="tudl", help="one of the BOP-7 datasets, or 'all'")
    p.add_argument("--checkpoint_path", default="none",
                   help="torch .ckpt/.pth; 'none' = resolve from the log dir via --iter, "
                        "or random weights if no checkpoint exists (smoke runs)")
    p.add_argument("--iter", type=int, default=-1,
                   help="checkpoint step to load from log/<model>/version_<id>/checkpoints; "
                        "-1 = latest")
    p.add_argument("--version_id", type=int, default=0)
    p.add_argument("--view", type=int, default=-1, help="override template view count (e.g. 42)")
    p.add_argument("--hyp", type=int, default=-1, help="override hypotheses")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--set", nargs="*", default=[], help="config overrides a.b=c")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv: list[str] | None = None) -> list[str]:
    """Run the evaluation; returns the CSV paths written."""
    args = get_parser().parse_args(argv)
    device = resolve_device(args.device)
    overrides = list(args.set)
    if args.view != -1:
        overrides.append(f"test_dataset.n_template_view={args.view}")
    cfg = load_config(args.config, overrides)
    hyp = args.hyp if args.hyp != -1 else cfg.model.hypothesis

    model = PicoPose(
        cfg.model.vit_type, tuple(cfg.model.blocks_to_take), _DTYPES[cfg.model.compute_dtype],
        device=device, quantize_stage3=cfg.model.quantize_stage3, fuse_xheads=cfg.model.fuse_xheads,
    )

    log_dir = os.path.join("log", args.model, f"version_{args.version_id}")
    ckpt_path = args.checkpoint_path
    step_dir = checkpoint_dir(log_dir)
    steps = {int(n.removesuffix(".pt")) for n in os.listdir(step_dir)
             if n.removesuffix(".pt").isdigit()} if os.path.isdir(step_dir) else set()
    if ckpt_path == "none" and steps:
        # resolve by step under the version's log dir, as the JAX entry point
        # does: <step>.pt is a train state; a <step>/ directory is an orbax
        # checkpoint, which load_any refuses
        step = args.iter if args.iter != -1 else max(steps)
        ckpt_path = checkpoint_path(log_dir, step)
        if not os.path.exists(ckpt_path):
            ckpt_path = os.path.join(step_dir, str(step))

    if ckpt_path != "none":
        print(f"loading checkpoint {ckpt_path}")
        load_flax_variables(model, load_any(ckpt_path, depth=VIT_CONFIGS[cfg.model.vit_type].depth))
    else:
        print("WARNING: random init (no checkpoint) — smoke run only")
        init_random_(model, 0)

    datasets = list(BOP7) if args.dataset == "all" else [args.dataset]
    written = []
    for name in datasets:
        # BOP-7 names use the CNOS default files; other datasets
        # <detection_dir>/<name>.json
        det = os.path.join(cfg.test_dataset.detection_dir, DETECTION_FILES.get(name, f"{name}.json"))
        ds = BOPTestDataset(
            cfg.test_dataset.data_dir, name, det,
            img_size=cfg.test_dataset.img_size,
            pts_size=cfg.test_dataset.pts_size,
            min_mask_px=cfg.test_dataset.minimum_n_point,
            seg_filter_score=cfg.test_dataset.seg_filter_score,
            n_template_view=cfg.test_dataset.n_template_view,
            rgb_mask_flag=cfg.test_dataset.rgb_mask_flag,
        )
        save_path = os.path.join(log_dir, f"{name}_eval", f"picopose-stage3-{hyp}hyp_{name}-test.csv")
        out = evaluate_dataset(
            model, ds, os.path.join(cfg.test_dataset.template_dir, name), save_path,
            hyp=hyp, batch_size=args.batch, stage3_topk=cfg.model.stage3_topk,
        )
        print(f"saved {out}")
        written.append(out)
    return written


if __name__ == "__main__":
    main()
