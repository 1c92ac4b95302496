"""Training entry point of the PyTorch port.

    python -m picopose_tpu_torch.run_train --model picopose --config configs/base.yaml \
        --version_id 0 [--resume] [--init_checkpoint PATH] [--max_steps N] \
        [--device cuda] [--set key=value ...]

Counterpart of run_train.py (:18-72) with the same flags plus ``--device``
(the card unless ``cpu`` is passed).  Logs and checkpoints go to
``log/<model>/version_<id>/`` under the working directory:
``training_logger.log`` and ``checkpoints/<step>.pt``.  The model is built
from ``cfg.model`` (ViT type, taps, compute dtype, ``remat_vit``,
``fuse_xheads``) and trained on one device by train/loop.py::run_training.
"""

from __future__ import annotations

import argparse
import os

import torch

from picopose_tpu_torch.device import resolve_device
from picopose_tpu_torch.train.loop import run_training
from picopose_tpu_torch.utils.config import load_config


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="PicoPose training (PyTorch port)")
    p.add_argument("--model", default="picopose")
    p.add_argument("--config", default="configs/base.yaml")
    p.add_argument("--version_id", type=int, default=0)
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in the log dir")
    p.add_argument("--init_checkpoint", default=None,
                   help="warm-start weights: a full PicoPose checkpoint (reference .ckpt/.pth "
                        "or a train state .pt) or raw DINOv2 backbone .pth (the reference's "
                        "pretrained=True)")
    p.add_argument("--max_steps", type=int, default=None, help="stop early (debug/smoke runs)")
    p.add_argument("--set", nargs="*", default=[], help="config overrides a.b=c")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv: list[str] | None = None) -> str:
    """Train; returns the log directory."""
    args = get_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(args.config, args.set)
    if args.init_checkpoint:
        cfg.trainer.init_checkpoint = args.init_checkpoint
    log_dir = os.path.join("log", args.model, f"version_{args.version_id}")
    os.makedirs(log_dir, exist_ok=True)
    print(f"training on {device}" + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    run_training(cfg, log_dir, resume=args.resume, max_steps=args.max_steps, device=device)
    return log_dir


if __name__ == "__main__":
    main()
